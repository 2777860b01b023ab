"""The port's pipelined fleet flow against its serial flow and against
the JAX package's ``solve_fleet`` at its defaults (CPU).

Three small services of config ``synth-fleet-8svc`` in three shape
classes (``chain0``: a two-pass chain cut into windows of 16; ``fanout``:
two-pass, five endpoints; ``cache``: single-pass, skip budget > 0), with
shape-class merging off so that the dispatcher builds three groups:

- pipelined == serial bit for bit, with and without a budget that makes
  the admission gate wait;
- an injected dispatch fault and an injected fetch fault recover on a
  flow worker with the serial flow's results and ``fault_*`` counts; a
  non-transient error propagates;
- the port pipelined vs JAX ``solve_fleet`` (``TW_PIPELINE=1``, its
  default): the same ledger and equal assignments up to near ties.

The ``gpu`` case runs pipelined vs serial on the card (it skips here).
JAX is imported inside the tests that use it, so that the ``gpu`` case
also runs where JAX is not installed (``--noconftest``).
"""

import re
import threading

import pytest
import torch

from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service as t_accuracy
from traceweaver_tpu_torch.metrics.synth import synth_fleet_8svc
from traceweaver_tpu_torch.runtime import faults as tfaults

torch.set_num_threads(1)  # small tensors; the test workers share the cores

N_TRACES = 48
SERVICES = ("chain0", "fanout", "cache")
#: the port's solve_fleet keywords of these tests: windows of 16 (so the
#: chain has several and compacts), no shape-class merging
PORT_KW = dict(max_window=16, merge_budget=0, device="cpu")
#: the JAX package's settings for the same solve
JAX_ENV = dict(TW_FLEET_MERGE="0", TW_PIPELINE="1", TW_CONF_DEVICE="0")
LEDGER_KEYS = ("fleet_dispatches", "fleet_services", "fused_em_applied",
               "fleet_dynamism_dispatches", "compact_windows_total",
               "compact_windows_redispatched")


# ---------------------------------------------------------------------------
# shared helpers (test_torch_plancache.py and test_torch_quality.py use them)
# ---------------------------------------------------------------------------

def three_services(n_traces=N_TRACES):
    """The port's problems of :data:`SERVICES`."""
    return [p for p in synth_fleet_8svc(n_traces) if p["service"] in SERVICES]


def jax_three_services(n_traces=N_TRACES):
    """The same problems built by the JAX package's generators."""
    from jax_reference_synth import synth_fleet_services

    return [p for p in synth_fleet_services(n_traces) if p["service"] in SERVICES]


def port_items(probs, **kw):
    return [tf.FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                         p["dag"], **kw) for p in probs]


def jax_items(probs, **kw):
    from traceweaver_tpu.algorithms.fleet import FleetItem

    return [FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                      p["dag"], **kw) for p in probs]


def jax_solve(monkeypatch, items, env=None, **kw):
    """JAX ``solve_fleet`` on the CPU with :data:`JAX_ENV` and ``env``
    (windows of 16)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.algorithms.fleet import solve_fleet

    for k, v in {**JAX_ENV, **(env or {})}.items():
        monkeypatch.setenv(k, v)
    return solve_fleet(items, max_window=16, **kw)


def identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]   # assignments
        assert x[1] == y[1]   # top-k
        assert x[2:] == y[2:]  # not_best, n, candidates, unassigned


def agreement(a, b):
    pairs = [(ep, i) for ep in b for i in b[ep]]
    return sum(a[ep][i] == b[ep][i] for ep, i in pairs) / len(pairs)


def faults_of(stats):
    return {k: v for k, v in stats.items() if k.startswith("fault")}


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serial():
    probs = three_services()
    stats = {}
    out = tf.solve_fleet(port_items(probs), stats=stats, pipeline=False, **PORT_KW)
    return probs, out, stats


def test_services_cover_three_shape_classes(serial):
    probs, _, stats = serial
    assert [p["service"] for p in probs] == list(SERVICES)
    assert stats["fleet_dispatches"] == 3.0
    assert stats["fused_em_applied"] == 2.0 and stats["fleet_dynamism_dispatches"] == 1.0
    assert stats["compact_windows_total"] > 0
    assert "pipeline_groups" not in stats


def test_pipelined_equals_serial(serial):
    probs, ref, ref_stats = serial
    stats = {}
    out = tf.solve_fleet(port_items(probs), stats=stats, **PORT_KW)
    assert stats["pipeline_groups"] == 3.0 and stats["pipeline_depth"] >= 1.0
    for k in LEDGER_KEYS:
        assert stats.get(k) == ref_stats.get(k), k
    identical(out, ref)


@pytest.mark.parametrize("pipeline", [True, False])
def test_binding_budget_equals_unbounded(serial, pipeline):
    """A budget equal to the largest group's cost: the serial flow drains
    and the pipeline's gate waits; neither changes an output, and no
    group falls back per service."""
    probs, ref, ref_stats = serial
    cost_max = int(ref_stats["fleet_group_cost_max"])
    assert ref_stats["fleet_group_cost_total"] > cost_max
    stats = {}
    out = tf.solve_fleet(port_items(probs), stats=stats, pipeline=pipeline,
                         fleet_budget_elems=cost_max // 4, **PORT_KW)
    assert "fleet_fallback_budget" not in stats
    if pipeline:
        assert stats["pipeline_depth"] < 3.0
    identical(out, ref)


@pytest.mark.parametrize("spec", ["dispatch:1.0:max=1", "fetch:1.0:max=1"])
def test_injected_fault_recovers_on_a_flow_worker(serial, monkeypatch, spec):
    probs, ref, _ = serial
    threads, real = [], tf._degrade_group

    def recording(*a, **kw):
        threads.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(tf, "_degrade_group", recording)
    by_flow = {}
    for pipeline in (False, True):
        stats = {}
        out = tf.solve_fleet(port_items(probs), stats=stats, pipeline=pipeline,
                             faults=tfaults.parse_faults(spec), retry_backoff_s=0.0,
                             **PORT_KW)
        identical(out, ref)
        by_flow[pipeline] = faults_of(stats)
    assert by_flow[True] == by_flow[False]
    site = spec.split(":")[0]
    assert by_flow[True]["faults_injected_" + site] == 1.0
    assert by_flow[True]["fault_ladder"] == ["retry"]
    assert by_flow[True]["fault_recovered_retry"] == 1.0
    assert threads[0] == "MainThread" and threads[1].startswith("tw-fleet-flow")


@pytest.mark.parametrize("err", [ValueError("a bug"),
                                 RuntimeError("fused_assign launch: CUDA error 700")])
def test_non_transient_error_propagates_from_a_flow(monkeypatch, err):
    def broken(*a, **kw):
        raise err

    monkeypatch.setattr(tf, "solve_windows_fleet", broken)
    stats = {}
    with pytest.raises(type(err), match=re.escape(str(err))):
        tf.solve_fleet(port_items(three_services(16)), stats=stats, **PORT_KW)
    assert stats["pipeline_groups"] == 3.0
    assert "fault_retries" not in stats


def test_one_flow_worker_equals_two(serial):
    probs, ref, _ = serial
    stats = {}
    out = tf.solve_fleet(port_items(probs), stats=stats, decode_workers=1, **PORT_KW)
    identical(out, ref)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_pipelined_matches_jax_at_its_defaults(serial, monkeypatch):
    from traceweaver_tpu.metrics.accuracy import accuracy_for_service as j_accuracy

    probs, _, _ = serial
    stats, ref_stats = {}, {}
    out = tf.solve_fleet(port_items(probs), stats=stats, **PORT_KW)
    jprobs = jax_three_services()
    ref = jax_solve(monkeypatch, jax_items(jprobs), stats=ref_stats)
    for k in LEDGER_KEYS + ("pipeline_groups",):
        assert stats.get(k) == ref_stats.get(k), k
    for p, jp, o, r in zip(probs, jprobs, out, ref):
        assert o[3] == r[3] == N_TRACES
        assert agreement(o[0], r[0]) >= 0.99, p["service"]
        assert abs(t_accuracy(o[0], p["truth"], p["in_parts"])
                   - j_accuracy(r[0], jp["truth"], jp["in_parts"])) <= 0.005


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_pipelined_equals_serial_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = synth_fleet_8svc(512)
    outs = {}
    for pipeline in (False, True):
        outs[pipeline] = tf.solve_fleet(port_items(probs), pipeline=pipeline,
                                        device="cuda")
        torch.cuda.synchronize()
    identical(outs[True], outs[False])
