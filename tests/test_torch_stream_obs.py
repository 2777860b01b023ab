"""The stream's observability pieces against the JAX package's (CPU).

- ``obs/quality.py``: ``psi`` over seeded numpy counts equal to JAX's to
  1e-12; ``ConfidenceDrift`` fed the same seeded confidence windows gives
  the same PSI sequence, alerts, excursion and maturity flags and
  checkpoint state, and survives ``state``/``from_state``;
  ``observe_trace`` lands on the histogram and the low counter.
- ``obs/selftrace.py``: the same recorded journeys give JAX's payload,
  and the payload loads back through the port's ingest (fix mode 6).
- the fleet's self-trace hook: a ``solve_fleet`` of items with trace
  keys stamps pack, dispatch and decode on each window's trace, and a
  fault plan that fails the first dispatch stamps the ``retry`` rung.
- ``obs/registry.py``: the stream's metric families.
"""

import json

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.obs import quality as Q
from traceweaver_tpu_torch.obs import selftrace as T

torch.set_num_threads(1)


def _jax_quality():
    import traceweaver_tpu.runtime.executor  # noqa: F401  (import order)
    from traceweaver_tpu.obs import quality

    return quality


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psi_matches_jax(seed):
    jq = _jax_quality()
    rng = np.random.default_rng(seed)
    for _ in range(20):
        ref = rng.integers(0, 50, 5).astype(float)
        cur = rng.integers(0, 50, 5).astype(float)
        assert abs(Q.psi(ref, cur) - jq.psi(ref, cur)) <= 1e-12
        vals = rng.uniform(0, 1, 64)
        assert Q._bin_counts(vals) == jq._bin_counts(vals)
    assert Q.PSI_EDGES == jq.PSI_EDGES
    assert Q.psi([10, 0, 0, 0, 0], [10, 0, 0, 0, 0]) == 0.0


def test_confidence_drift_matches_jax():
    """A shift in the middle of the stream: the same PSI after every
    update, the same single alert, excursion and re-arm, the same state."""
    jq = _jax_quality()
    rng = np.random.default_rng(7)
    ours = Q.ConfidenceDrift(window=32, threshold=0.25)
    ref = jq.ConfidenceDrift(window=32, threshold=0.25)
    for step in range(40):
        lo, hi = (0.6, 1.0) if step < 15 or step >= 30 else (0.0, 0.4)
        vals = list(rng.uniform(lo, hi, int(rng.integers(0, 12))))
        a, b = ours.update("svc", vals), ref.update("svc", vals)
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= 1e-12
        assert ours.in_excursion("svc") == ref.in_excursion("svc")
        assert ours.mature("svc") == ref.mature("svc")
    assert ours.alerts == ref.alerts >= 1
    assert ours.state() == ref.state()
    back = Q.ConfidenceDrift.from_state(ours.state())
    assert back.state() == ours.state()
    assert back.last_psi("svc") == ours.last_psi("svc")
    assert Q.ConfidenceDrift().window == 256 and Q.ConfidenceDrift().threshold == 0.25


def test_observe_trace_counts_low():
    from traceweaver_tpu_torch.obs.registry import get_registry

    snap = get_registry().snapshot()
    key = 'tw_low_confidence_traces_total{tenant="t-obs"}'
    before = snap.get(key, 0.0)
    assert Q.observe_trace(0.2, "t-obs") is True
    assert Q.observe_trace(0.9, "t-obs") is False
    assert Q.observe_trace(0.5, "t-obs", low=0.6) is True
    after = get_registry().snapshot()
    assert after[key] == before + 2
    assert after['tw_trace_confidence_count{tenant="t-obs"}'] >= 3


def _record(tracer_mod):
    tr = tracer_mod.PipelineTracer()
    t = 1.7e15
    for k in range(3):
        key = str(k)
        tr.touch(key, t + k * 100)
        tr.seal(key, t + k * 100 + 40)
        tr.stage(key, "pack", t + k * 100 + 41, t + k * 100 + 45)
        tr.stage(key, "dispatch", t + k * 100 + 45, t + k * 100 + 60)
        tr.stage(key, "dispatch", t + k * 100 + 62, t + k * 100 + 70)  # merged
        if k == 1:
            tr.stage(key, "retry", t + k * 100 + 61, t + k * 100 + 62)
        tr.stage(key, "decode", t + k * 100 + 70, t + k * 100 + 75)
        tr.finish(key, t + k * 100 + 80)
    tr.touch("empty", t)  # no stages: left out of the payload
    return tr


def test_selftrace_payload_matches_jax(tmp_path):
    import traceweaver_tpu.runtime.executor  # noqa: F401
    from traceweaver_tpu.obs import selftrace as jT

    ours, ref = _record(T), _record(jT)
    assert ours.payload() == ref.payload()
    assert len(ours) == 4 and len(ours.payload()["data"]) == 3
    path = str(tmp_path / "journey.json")
    assert ours.write(path) == 3
    assert json.load(open(path)) == ref.payload()
    # the payload loads back as a corpus of fix mode 6
    from traceweaver_tpu_torch.ingest import parse_trace_payload

    parsed = parse_trace_payload(ours.payload(), T.SELFTRACE_FIX, {}, {})
    assert len(parsed) == 3
    assert T.install(ours) is None and T.active() is ours
    assert T.install(None) is ours and T.active() is None


def _fleet_items(n_svc=2, n=48):
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem
    from traceweaver_tpu_torch.metrics.synth import synth_labeled_corpus

    probs = synth_labeled_corpus(0, n)[:n_svc]
    return [FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                      p["dag"], trace_key=f"w{i}") for i, p in enumerate(probs)]


def test_fleet_stamps_window_traces():
    """With a tracer installed, every item's window trace gets pack,
    dispatch and decode; a failed first dispatch adds the retry rung;
    the assignments equal those of a run with no tracer."""
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.runtime import faults

    plain = solve_fleet(_fleet_items(), device="cpu")
    tr = T.PipelineTracer()
    prev = T.install(tr)
    try:
        out = solve_fleet(_fleet_items(), device="cpu",
                          faults=faults.parse_faults("dispatch:1.0:max=1"),
                          retry_backoff_s=0.0)
    finally:
        T.install(prev)
    assert [o[0] for o in out] == [o[0] for o in plain]
    traces = {t["traceID"]: {s["operationName"] for s in t["spans"]}
              for t in tr.payload()["data"]}
    assert set(traces) == {"twtrace-w0", "twtrace-w1"}
    for ops in traces.values():
        assert {"pack", "dispatch", "decode"} <= ops
    assert any("retry" in ops for ops in traces.values())


def test_stream_metric_families():
    from traceweaver_tpu_torch.obs.registry import MetricsRegistry, stream_families

    reg = MetricsRegistry()
    fam = stream_families(reg)
    assert set(fam) == {"ledger", "solve_s", "seal_emit_s", "slo_breach",
                        "backpressure", "watchdog"}
    fam["backpressure"].inc(outcome="spilled")
    fam["solve_s"].observe(0.3)
    snap = reg.snapshot()
    assert snap['tw_stream_backpressure_total{outcome="spilled"}'] == 1.0
    assert snap["tw_solve_seconds_count"] == 1.0
    assert stream_families(reg)["ledger"] is fam["ledger"]  # idempotent
