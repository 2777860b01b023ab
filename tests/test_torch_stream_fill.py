"""The stream's batch-fill admission against the JAX package's (CPU).

``StreamConfig.solve_min_batch`` (pump once that many windows are
sealed), ``StreamConfig.prune`` (retention-prune the live store) and
``slo_p99_ms`` as an admission rule (``_slo_pressure``: a sealed window
past half the SLO budget is pumped whatever the fill):

- ``_slo_pressure`` follows JAX's unit sequence
  (``tests/test_continuous.py::test_stream_slo_pressure_unit``);
- under ``solve_min_batch=3`` the run loop pumps only at three sealed
  windows (the end of the stream drains the rest);
- ``prune=False`` keeps every span in the live store;
- JAX's 40-trace stream fixture replayed with ``solve_min_batch=2`` (and
  3, and a tiny SLO over an unreachable fill) is held to JAX's stream:
  the same windows, counters and micro-batches, >= 99% equal rows,
  streamed accuracy within 0.5 pt.
"""

import json
import time

import pytest
import torch

torch.set_num_threads(1)

WINDOWS = dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=1e6, grace_us=0.0,
               checkpoint_every=10_000, verbose=False)


def _jax():
    """The JAX package's stream modules (its executor first: a cold
    ``traceweaver_tpu.ingest`` import is circular)."""
    import traceweaver_tpu.runtime.executor  # noqa: F401
    import traceweaver_tpu.stream as js

    return js


def _buf(k, n_spans, sealed_ago_s=0.0):
    from traceweaver_tpu_torch.stream.window import WindowBuffer

    buf = WindowBuffer(k, float(k), float(k) + 1.0)
    buf.spans = [None] * n_spans
    buf.sealed_wall = time.monotonic() - sealed_ago_s
    return buf


def test_slo_pressure_unit():
    from traceweaver_tpu_torch.stream import StreamConfig, StreamingReconstructor

    svc = StreamingReconstructor(None, StreamConfig(slo_p99_ms=1000.0, verbose=False),
                                 device="cpu")
    assert svc._slo_pressure() is False        # nothing sealed
    svc.scheduler.offer(_buf(0, 4, sealed_ago_s=0.0))
    assert svc._slo_pressure() is False        # a fresh window waits
    svc.scheduler.offer(_buf(1, 4, sealed_ago_s=5.0))
    assert svc._slo_pressure() is True         # past half the budget
    svc2 = StreamingReconstructor(None, StreamConfig(verbose=False), device="cpu")
    svc2.scheduler.offer(_buf(2, 4, sealed_ago_s=500.0))
    assert svc2._slo_pressure() is False       # no SLO: inert


def test_defaults_are_the_old_behaviour():
    from traceweaver_tpu_torch.stream import StreamConfig

    cfg = StreamConfig()
    assert cfg.solve_min_batch == 1 and cfg.prune is True and cfg.slo_p99_ms is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    root = tmp_path_factory.mktemp("fill_corpus")
    (d,) = synthesize_corpus(str(root / "cg"), n_graphs=1, traces_per_graph=40,
                             seed=7)
    return d


def _source(mod, d):
    return mod.parse_source_spec(f"replay:{d}?fix=5&max_traces=40&ooo_ms=50&seed=1")


def _port(d, sink=None, **kw):
    import traceweaver_tpu_torch.stream as ps

    svc = ps.StreamingReconstructor(_source(ps, d), ps.StreamConfig(**WINDOWS, **kw),
                                    sink=ps.TraceSink(sink) if sink else None,
                                    device="cpu")
    return svc


def test_min_batch_pumps_only_at_three_sealed(corpus):
    svc = _port(corpus, solve_min_batch=3)
    pumped = []
    real = svc.scheduler.pump
    finishing = []

    def pump(*a, **k):
        pumped.append((len(svc.scheduler.ready()), bool(finishing)))
        return real(*a, **k)

    real_finish = svc.finish

    def finish():
        finishing.append(True)
        return real_finish()

    svc.scheduler.pump = pump
    svc.finish = finish
    summary = svc.run()
    in_loop = [n for n, fin in pumped if not fin]
    assert in_loop and all(n >= 3 for n in in_loop)
    assert summary["emitted_windows"] >= 4
    assert summary["stats"]["spans_emitted"] == summary["consumed"]
    # the default pumps every sealed window as it comes
    default = _port(corpus)
    pumped_default = []
    real_d = default.scheduler.pump
    default.scheduler.pump = lambda *a, **k: (
        pumped_default.append(len(default.scheduler.ready())), real_d(*a, **k))[1]
    default.run()
    assert len(pumped_default) > len(pumped)


def test_prune_false_keeps_the_live_store(corpus):
    kept = _port(corpus, prune=False)
    s = kept.run()
    assert kept.live.n_pruned == 0
    assert len(kept.live.all_spans) == s["consumed"]
    pruned = _port(corpus)
    pruned.run()
    assert len(pruned.live.all_spans) < s["consumed"]
    assert s["stats"]["spans_emitted"] == s["consumed"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _rows(recs):
    out = {}
    for r in recs:
        for svc, eps in r["services"].items():
            for ep, pairs in eps.items():
                for i, o in pairs:
                    out.setdefault(f"{svc}|{ep}", {})[tuple(i)] = tuple(o)
    return out


@pytest.mark.parametrize("kw", [dict(solve_min_batch=2), dict(solve_min_batch=3),
                                dict(solve_min_batch=10**6, slo_p99_ms=1e-6)],
                         ids=["fill2", "fill3", "slo"])
def test_fill_replay_matches_jax(corpus, tmp_path, kw):
    from traceweaver_tpu_torch.ops.compare import pair_agreement

    js = _jax()
    jsvc = js.StreamingReconstructor(_source(js, corpus),
                                     js.StreamConfig(**WINDOWS, **kw),
                                     sink=js.TraceSink(str(tmp_path / "jax.jsonl")))
    jsum = jsvc.run()
    jsvc.sink.close()
    psvc = _port(corpus, sink=str(tmp_path / "port.jsonl"), **kw)
    psum = psvc.run()
    psvc.sink.close()
    for key in ("consumed", "emitted_windows", "late_rerouted", "late_dropped",
                "shed_spilled", "shed_dropped_windows", "deadletter_windows"):
        assert psum[key] == jsum[key], key
    assert psum["stats"]["micro_batches"] == jsum["stats"]["micro_batches"]
    assert psum["stats"]["spans_emitted"] == jsum["stats"]["spans_emitted"] \
        == psum["consumed"]
    jrec, prec = _records(str(tmp_path / "jax.jsonl")), _records(str(tmp_path / "port.jsonl"))
    assert [r["window"] for r in prec] == [r["window"] for r in jrec]
    assert pair_agreement(_rows(prec), _rows(jrec)) >= 0.99
    assert abs(psum["accuracy"]["e2e"] - jsum["accuracy"]["e2e"]) <= 0.5
