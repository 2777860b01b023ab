"""Reference accuracy of the JAX package on the port's synthetic configs.

The PyTorch port's ``chip_smoke.py`` holds its on-card accuracy against
these numbers (minus one point). Run on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py [--traces 8192]
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config synth-fleet-8svc
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-15000
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-cg-8k
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-gtfree
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-cg-8k-gtfree
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-ladder
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-ladder-hard
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config stream-cg-8k
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config stream-cg-8k-batch
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config serve-cg-4t
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config capture-8k [--traces 40]
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config adapt-burst-60 [--n_req 1024]
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config kde-async-8k
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config stream-cg-4k-fill4

``TW_PRECISION=bf16`` and ``TW_SCORE_GEMM=1`` in the environment give the
JAX package's bf16 and GEMM score paths on any config.

``synth-async-8k`` (the default) runs ``WeaverTPU.FindAssignments`` and
prints one JSON line: accuracy, wall seconds and the solver's
``fused_em_applied`` flag. ``synth-fleet-8svc`` runs ``solve_fleet`` over
the eight services and prints one JSON line with each service's
accuracy and the fleet's dispatch counters. The inputs are the repo's
synthetic labelled services (``metrics/scorecard.py _make_service`` and
``synth_labeled_corpus``, ``synth/transforms.py create_cache_hits``),
built exactly as ``traceweaver_tpu_torch.metrics.synth`` builds them.

``alibaba-exp5-15000`` synthesizes exp5's corpus (15 call graphs x 1000
traces, seed 10, replica table included) and runs the JAX executor on
each graph with exp5's arguments (fix 5, compress 15000, predictors
3,4,7,10, ``execute_parallel`` off), then graph 0 again with exp4's
predictors 2,8,9,10 at compress 1; ``alibaba-cg-8k`` is the first call
graph of seed 10 at 8192 traces, compress 15000, predictor 10. Each
prints one JSON line per run with the end-to-end accuracy per method.
``alibaba-exp5-gtfree`` and ``alibaba-cg-8k-gtfree`` are exp5's top
rung and ``alibaba-cg-8k`` with predictor 10 alone and ground-truth-free
invocation-DAG discovery (``gt_free_dag``); their lines also give each
service's discovered edges.

``alibaba-exp5-ladder`` is exp5's whole ladder
(``exps/exp5/run_experiment.sh``): compress 1, 200, 1000, 4000, 10000 and
15000 over the 15 graphs, predictors 3,4,7,10, one JSON line per rung
and graph; ``alibaba-exp5-ladder-hard`` the same over the messy corpus
(``run_experiment_hard.sh``: ``synthesize_corpus(messy=MESSY_DEFAULT)``).
``--graphs 0,4`` and ``--rungs 10000,15000`` limit either ladder to
those graphs and compress factors.

``stream-cg-8k`` replays one synthesized call graph (seed 10, 8192
traces, 20 ms between trace arrivals) through the JAX package's
streaming reconstructor (``replay:<dir>?fix=5&max_traces=8192&ooo_ms=50
&seed=1``, 20 s windows, 4 s overlap, 2 s watermark, no grace, four
pending windows), then the batch executor (predictor 10) on the same
store, and prints one JSON line: the streamed end-to-end accuracy, the
window, late and shed counts, and the batch accuracy.
``stream-cg-8k-batch`` runs that batch executor alone, in a process
that has run no stream.

``serve-cg-4t`` synthesizes four call graphs (seed 10, 8192 traces, 20
ms apart) and serves them through the JAX package's ``TenantService`` in
this process, tenant ``t<i>`` posting graph ``i`` in bodies of 256
traces in root start-time order (``chip_smoke.serve_bodies``), one
thread a tenant, with the serve CLI's defaults (continuous admission,
two tickets in flight, the WAL) and the stream's geometry (20 s
windows, 4 s overlap, 2 s watermark); then tenant ``t0`` alone under the
fixed pump, eight windows a pump and then one. Each part prints one
JSON line with every tenant's window, span and trace counts and the
accuracy of its sink (``chip_smoke.serve_sink_accuracy``). ``--part
shared``, ``alone`` or ``alone1`` runs one of them; ``TW_DEVCOLS=0`` in
front gives the host packer's readings, which the port is held to.

``kde-async-8k`` is ``synth-async-8k`` through ``WeaverTPU(score_mode=
"kde")``: the binned-KDE score mode, two unfused passes with the host
refit between them. ``stream-cg-4k-fill4`` replays the first 4096 traces
of ``stream-cg-8k``'s corpus through the streaming reconstructor with
the stream's geometry and ``solve_min_batch=4`` (batch-fill admission,
no SLO), and prints the streamed accuracy and the micro-batch counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402

from traceweaver_tpu.algorithms.weaver_tpu import WeaverTPU  # noqa: E402
from traceweaver_tpu.metrics.accuracy import accuracy_for_service  # noqa: E402
from traceweaver_tpu.metrics.scorecard import (  # noqa: E402
    _make_service,
    synth_labeled_corpus,
)
from traceweaver_tpu.synth import create_cache_hits  # noqa: E402


def _chain(prob, n_eps: int):
    """``prob`` with its endpoints made a chain in its DAG."""
    svc = prob["service"]
    dag = nx.DiGraph()
    dag.add_nodes_from(prob["out_parts"])
    dag.add_edges_from([(f"{svc}-ep{e}", f"{svc}-ep{e + 1}")
                        for e in range(n_eps - 1)])
    prob["dag"] = dag
    return prob


def synth_async_service(n_traces: int, seed: int = 0, svc: str = "svc"):
    """``synth-async-8k`` at ``n_traces`` (8192 is the config's size)."""
    return _chain(_make_service(svc, n_traces=n_traces, n_eps=3,
                                rng=np.random.default_rng(seed),
                                spacing_us=6000.0, burst=n_traces,
                                jitter_us=10.0), 3)


def synth_fleet_services(n_traces: int = 8192, seed: int = 0):
    """``synth-fleet-8svc`` at ``n_traces`` per service: chain0-chain3,
    async, fanout, seq, cache (``metrics/synth.py synth_fleet_8svc``)."""
    chains = [synth_async_service(n_traces, seed + i, svc=f"chain{i}")
              for i in range(4)]
    seq, async_, fanout = synth_labeled_corpus(seed, n_traces)
    cache = _chain(_make_service("cache", n_traces, 3, np.random.default_rng(seed + 4),
                                 spacing_us=6000.0, burst=6, jitter_us=2.0), 3)
    cache["truth"] = create_cache_hits(cache["truth"], cache["in_parts"],
                                       cache["out_parts"], cache_rate=0.1)
    return chains + [async_, fanout, seq, cache]


def run_fleet(probs, stats=None):
    """JAX ``solve_fleet`` over the services; returns its results."""
    from traceweaver_tpu.algorithms.fleet import FleetItem, solve_fleet

    items = [FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                       p["dag"]) for p in probs]
    return solve_fleet(items, stats=stats)


def run_alibaba(graph_dir: str, replica_table, predictors, compress: float,
                max_traces: int = 1000, gt_free_dag: bool = False) -> dict:
    """JAX ``run_experiment`` on one call graph with exp5's arguments
    (``exps/common.sh run_executor``); returns the end-to-end accuracy
    per method (percent) and the wall seconds."""
    from traceweaver_tpu.runtime.executor import ExecutorConfig, run_experiment

    cfg = ExecutorConfig(
        data_path=graph_dir, results_directory="", fix=5, cache_rate=0.0,
        load_level=1, compress_factor=compress, repeat_factor=1,
        execute_parallel=False, predictor_indices=list(predictors),
        max_traces=max_traces, service_to_replica=replica_table,
        gt_free_dag=gt_free_dag)
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    out = dict(accuracy=res.accuracy_overall, wall_s=time.perf_counter() - t0)
    if gt_free_dag:
        out["edges"] = {svc: [list(e) for e in g.edges()] for svc, g in
                        sorted(res.store._gt_free_dag_cache.items())}
    return out


LADDER_RUNGS = (1.0, 200.0, 1000.0, 4000.0, 10000.0, 15000.0)


def ladder_config(config: str, out_root: str, graphs=None, rungs=LADDER_RUNGS) -> None:
    """exp5's ladder (clean, or messy with ``-hard``): every rung of every
    graph, rung by rung as the shell script runs them."""
    from traceweaver_tpu.alibaba.synthesize import MESSY_DEFAULT, synthesize_corpus
    from traceweaver_tpu.runtime.executor import load_replica_table

    messy = MESSY_DEFAULT if config.endswith("-hard") else None
    dirs = synthesize_corpus(out_root, n_graphs=15, traces_per_graph=1000,
                             seed=10, messy=messy)
    table = load_replica_table(os.path.join(out_root, "misc",
                                            "service_to_replica_new.pickle"))
    for compress in rungs:
        for n, d in enumerate(dirs):
            if graphs is not None and n not in graphs:
                continue
            r = run_alibaba(d, table, (3, 4, 7, 10), compress)
            print(json.dumps(dict(config=config, graph=os.path.basename(d),
                                  compress=compress, **r,
                                  backend=jax.default_backend())), flush=True)


def alibaba_configs(config: str, out_root: str) -> None:
    from traceweaver_tpu.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu.runtime.executor import load_replica_table

    big = config.startswith("alibaba-cg-8k")
    gt_free = config.endswith("-gtfree")
    n_graphs, traces = (1, 8192) if big else (15, 1000)
    dirs = synthesize_corpus(out_root, n_graphs=n_graphs,
                             traces_per_graph=traces, seed=10)
    table = load_replica_table(os.path.join(out_root, "misc",
                                            "service_to_replica_new.pickle"))
    runs = [(d, (10,) if big or gt_free else (3, 4, 7, 10), 15000.0)
            for d in dirs]
    if not big and not gt_free:
        runs.append((dirs[0], (2, 8, 9, 10), 1.0))
    for d, preds, compress in runs:
        r = run_alibaba(d, table, preds, compress, max_traces=traces,
                        gt_free_dag=gt_free)
        print(json.dumps(dict(config=config, graph=os.path.basename(d),
                              predictors=list(preds), compress=compress,
                              **r, backend=jax.default_backend())),
              flush=True)


#: ``stream-cg-8k``: the corpus, the replay spec's query and the windows
STREAM_CG8K = dict(n_graphs=1, traces_per_graph=8192, seed=10, base_gap_ms=20)
STREAM_CG8K_QUERY = "fix=5&max_traces=8192&ooo_ms=50&seed=1"
STREAM_CG8K_WINDOWS = dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6,
                           grace_us=0.0, max_pending=4)


def stream_config(out_root: str, stream: bool = True) -> None:
    """``stream-cg-8k`` through the JAX package's ``StreamingReconstructor``
    (unless ``stream`` is false) and, on the identical store, its batch
    executor."""
    from traceweaver_tpu.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu.runtime.executor import ExecutorConfig, run_experiment
    from traceweaver_tpu.stream import (
        StreamConfig,
        StreamingReconstructor,
        parse_source_spec,
    )

    (d,) = synthesize_corpus(out_root, **STREAM_CG8K)
    source = parse_source_spec(f"replay:{d}?{STREAM_CG8K_QUERY}")

    def batch():
        t0 = time.perf_counter()
        res = run_experiment(ExecutorConfig(
            data_path="", results_directory="", fix=5, cache_rate=0.0,
            test_name="streamcmp", predictor_indices=[10]), store=source.store)
        return res.accuracy_overall["MaxScoreBatchSubsetWithSkips"], time.perf_counter() - t0

    if not stream:
        acc, wall = batch()
        print(json.dumps(dict(config="stream-cg-8k-batch", batch_e2e=acc, wall_s=wall,
                              backend=jax.default_backend())), flush=True)
        return
    svc = StreamingReconstructor(source, StreamConfig(
        verbose=False, **STREAM_CG8K_WINDOWS))
    t0 = time.perf_counter()
    summary = svc.run()
    wall = time.perf_counter() - t0
    batch_acc, _ = batch()
    stats = summary["stats"]
    print(json.dumps(dict(
        config="stream-cg-8k", events=len(source),
        consumed=summary["consumed"], windows=summary["emitted_windows"],
        micro_batches=int(stats.get("micro_batches", 0)),
        spans_emitted=int(stats.get("spans_emitted", 0)),
        late_rerouted=summary["late_rerouted"],
        late_dropped=summary["late_dropped"],
        shed_spilled=summary["shed_spilled"],
        shed_dropped_windows=summary["shed_dropped_windows"],
        deadletter_windows=summary["deadletter_windows"],
        streamed_e2e=summary["accuracy"]["e2e"],
        per_service=summary["accuracy"]["per_service"],
        batch_e2e=batch_acc, wall_s=wall, backend=jax.default_backend())), flush=True)


STREAM_FILL4_QUERY = "fix=5&max_traces=4096&ooo_ms=50&seed=1"
STREAM_FILL4_MIN_BATCH = 4


def stream_fill4_config(out_root: str) -> None:
    """``stream-cg-4k-fill4``: ``stream-cg-8k``'s corpus cut to its first
    4096 traces, pumped only once four windows are sealed."""
    from traceweaver_tpu.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu.stream import (
        StreamConfig,
        StreamingReconstructor,
        parse_source_spec,
    )

    (d,) = synthesize_corpus(out_root, **STREAM_CG8K)
    source = parse_source_spec(f"replay:{d}?{STREAM_FILL4_QUERY}")
    svc = StreamingReconstructor(source, StreamConfig(
        verbose=False, solve_min_batch=STREAM_FILL4_MIN_BATCH,
        **STREAM_CG8K_WINDOWS))
    t0 = time.perf_counter()
    summary = svc.run()
    wall = time.perf_counter() - t0
    stats = summary["stats"]
    print(json.dumps(dict(
        config="stream-cg-4k-fill4", events=len(source),
        consumed=summary["consumed"], windows=summary["emitted_windows"],
        micro_batches=int(stats.get("micro_batches", 0)),
        spans_emitted=int(stats.get("spans_emitted", 0)),
        late_rerouted=summary["late_rerouted"],
        late_dropped=summary["late_dropped"],
        shed_spilled=summary["shed_spilled"],
        shed_dropped_windows=summary["shed_dropped_windows"],
        streamed_e2e=summary["accuracy"]["e2e"],
        per_service=summary["accuracy"]["per_service"],
        wall_s=wall, backend=jax.default_backend())), flush=True)


def serve_config(out_root: str, part: str = "both") -> None:
    """``serve-cg-4t`` through the JAX package's ``TenantService``: the
    shared run of four tenants (continuous admission) and, with ``part``
    ``"alone"`` or ``"both"``, tenant ``t0`` alone under the fixed pump.
    The Alibaba self-loop ids draw from the global RNG, seeded 10 before
    each run."""
    import random
    import threading

    import traceweaver_tpu.runtime.executor  # noqa: F401 (the ingest cycle)
    from traceweaver_tpu.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu.serve import ServeConfig, TenantService

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    t0 = time.perf_counter()
    dirs = synthesize_corpus(os.path.join(out_root, "corpus"), **CS.SERVE_CORPUS)
    bodies = [CS.serve_bodies(d) for d in dirs]
    truths = [CS.serve_truth(d) for d in dirs]
    print(json.dumps(dict(config="serve-cg-4t-corpus", posts=[len(b) for b in bodies],
                          synth_s=time.perf_counter() - t0)), flush=True)

    def run(tag, tenants, continuous, pump_windows=CS.SERVE_SETTINGS["pump_windows"]):
        random.seed(10)
        state = os.path.join(out_root, tag)
        cfg = ServeConfig(state_dir=state, verbose=False, continuous=continuous,
                          **dict(CS.SERVE_SETTINGS, pump_windows=pump_windows))
        svc = TenantService(cfg)
        t_run = time.perf_counter()

        def post(i):
            for body in bodies[i]:
                svc.wal_ingest(CS.SERVE_TENANTS[i], body, raw=body)

        threads = [threading.Thread(target=post, args=(i,)) for i in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        svc.flush()
        while svc.total_backlog() or svc.in_flight_windows():
            time.sleep(0.05)
        wall = time.perf_counter() - t_run
        st = svc.stats()
        svc.drain()
        out = {}
        for i in tenants:
            tid = CS.SERVE_TENANTS[i]
            t = st["tenants"][tid]
            acc = CS.serve_sink_accuracy(os.path.join(state, tid, "traces.jsonl"),
                                         truths[i])
            acc.pop("rows_by_key")
            acc.pop("window_of")
            out[tid] = dict(
                posts=int(t["counters"].get("posts", 0)), consumed=t["consumed"],
                emitted_windows=t["emitted_windows"], solved_windows=t["solved_windows"],
                spans_emitted=t["spans_emitted"], traces_emitted=t["traces_emitted"],
                late_dropped=t["late_dropped"], late_rerouted=t["late_rerouted"],
                shed_spilled=t["shed_spilled"],
                shed_dropped_windows=t["shed_dropped_windows"],
                deadletter_windows=t["deadletter_windows"], **acc)
        print(json.dumps(dict(
            config="serve-cg-4t", part=tag, continuous=continuous, tenants=out,
            dispatch=st["dispatch"], ring=st["ring"], wall_s=wall,
            devcols_fallbacks=st["fleet"].get("devcols_fallbacks", 0.0),
            backend=jax.default_backend())), flush=True)

    if part in ("shared", "both"):
        run("shared", range(len(dirs)), True)
    if part in ("alone", "both"):
        run("t0-alone", [0], False)
    if part in ("alone1", "both"):
        run("t0-alone-pump1", [0], False, pump_windows=1)


CAPTURE_WINDOWS = dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6)
CAPTURE_LEGS = (("clean", None), ("skew", "skew:1.0:max=1"), ("lossy", "capture:0.04"))


def capture_config(n_traces: int) -> None:
    """``capture-8k``: ``bench.py``'s capture workload at ``n_traces``
    traces through the JAX package's collector ingress and stream, at
    ``stream-cg-8k``'s geometry, clean, under ``skew:1.0:max=1`` and under
    ``capture:0.04`` (fault seed 1, as ``bench.py run_capture_leg``). One
    JSON line per leg."""
    import tempfile

    import bench
    from traceweaver_tpu.collector.source import CollectorSource
    from traceweaver_tpu.runtime import faults as faults_mod
    from traceweaver_tpu.stream.service import StreamConfig, StreamingReconstructor, TraceSink

    os.environ["TW_RETRY_BACKOFF_S"] = "0"
    logs = bench._capture_workload(n_traces)
    for leg, spec in CAPTURE_LEGS:
        faults_mod.reset()
        if spec:
            with faults_mod.override(spec, seed=1):
                src = CollectorSource(logs)
        else:
            src = CollectorSource(logs)
        with tempfile.TemporaryDirectory() as tmp:
            sink = os.path.join(tmp, "out.jsonl")
            svc = StreamingReconstructor(src, StreamConfig(
                checkpoint_every=10_000, verbose=False, **CAPTURE_WINDOWS),
                sink=TraceSink(sink))
            t0 = time.perf_counter()
            summary = svc.run()
            wall = time.perf_counter() - t0
            confs, discount = [], None
            with open(sink) as f:
                for raw in f:
                    tw = json.loads(raw).get("tw.confidence") or {}
                    confs += [t["conf"] for t in (tw.get("traces") or {}).values()
                              if t is not None]
                    if tw.get("capture") is not None:
                        discount = tw["capture"]["discount"]
        q = summary.get("capture", {})
        skews = [v for v in q.get("skew_us", {}).values() if v]
        print(json.dumps(dict(
            config="capture-8k", traces=n_traces, leg=leg, faults=spec,
            events=len(src), windows=summary["emitted_windows"],
            spans_emitted=int(summary["stats"].get("spans_emitted", 0)),
            late_rerouted=summary["late_rerouted"], late_dropped=summary["late_dropped"],
            accuracy=summary["accuracy"]["e2e"],
            per_service=summary["accuracy"]["per_service"],
            loss=q.get("loss", {}), loss_rate=q.get("loss_rate"),
            rekeyed=q.get("rekeyed_streams"), skew_us=q.get("skew_us"),
            skew_detected_us=max(skews, key=abs) if skews else None,
            conf_mean=sum(confs) / len(confs) if confs else None,
            conf_discount=discount, wall_s=wall, backend=jax.default_backend())),
            flush=True)
    faults_mod.reset()


def adapt_config(n_bursts: int, n_req: int) -> None:
    """``adapt-burst-60`` (``n_req`` 8, ``bench.py run_adapt_leg``'s
    recorded leg) and ``adapt-burst-60x1024``: the shifted burst corpus
    through the JAX package's stream with ``TW_ADAPT`` 0 (control) and 1,
    1 s windows, no overlap, a 1 ms bound, drift window 64. One JSON line
    per run with the per-window accuracies."""
    import tempfile

    import bench
    from traceweaver_tpu.stream.service import StreamConfig, StreamingReconstructor, TraceSink
    from traceweaver_tpu.stream.sources import IterableSource

    os.environ["TW_RETRY_BACKOFF_S"] = "0"
    os.environ["TW_CONF_DRIFT_WINDOW"] = "64"
    shift_at = max(4, n_bursts // 2)
    tail_n = max(6, n_bursts // 6)
    for adapt_on in (False, True):
        os.environ["TW_ADAPT"] = "1" if adapt_on else "0"
        events, _ = bench._adapt_burst_events(n_bursts, shift_at, n_req=n_req)
        with tempfile.TemporaryDirectory() as tmp:
            sink = os.path.join(tmp, "out.jsonl")
            svc = StreamingReconstructor(IterableSource(events), StreamConfig(
                window_us=1e6, overlap_us=0.0, ooo_bound_us=1e3,
                checkpoint_every=10_000, verbose=False), sink=TraceSink(sink))
            t0 = time.perf_counter()
            summary = svc.run()
            wall = time.perf_counter() - t0
            with open(sink) as f:
                lines = f.readlines()
        accs = _adapt_accs(lines, n_req)
        keys = sorted(accs)
        pre = [accs[k] for k in keys if k < shift_at]
        tail = [accs[k] for k in keys[-tail_n:]]
        psi = svc.drift.last_psi("frontend") if svc.drift else None
        ad = summary["adapt"]
        print(json.dumps(dict(
            config="adapt-burst-%d%s" % (n_bursts, "" if n_req == 8 else "x%d" % n_req),
            adapt=adapt_on, events=len(events), windows=len(accs),
            window_acc=[accs[k] for k in keys],
            pre=sum(pre) / len(pre) if pre else None,
            tail=sum(tail) / len(tail) if tail else None,
            drift_alerts=summary["confidence"]["drift_alerts"],
            refits=ad.get("refits_done", 0), fallbacks=ad.get("fallbacks", 0),
            actions={k: ad[k] for k in ("refits_scheduled", "refits_done",
                                        "refits_failed", "fallbacks", "restores",
                                        "recoveries")} if ad.get("enabled") else None,
            final_psi=psi, wall_s=wall, backend=jax.default_backend())), flush=True)


def _adapt_accs(lines, n_req):
    """Per-window accuracy of an adapt-burst sink (``bench.py``'s grading)."""
    skip_sid = "r%02d" % (n_req - 1)
    accs = {}
    for line in lines:
        rec = json.loads(line)
        rows = rec.get("services", {}).get("frontend", {}).get("search", [])
        if not rows:
            continue
        ok = 0
        for in_id, out_id in rows:
            is_real = isinstance(out_id, list) and str(out_id[0]).startswith("b")
            if in_id[0].endswith(skip_sid):
                ok += not is_real
            else:
                ok += is_real and out_id[0] == in_id[0]
        accs[rec["window"]] = ok / len(rows)
    return accs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="synth-async-8k",
                    choices=("synth-async-8k", "synth-fleet-8svc",
                             "alibaba-exp5-15000", "alibaba-cg-8k",
                             "alibaba-exp5-gtfree", "alibaba-cg-8k-gtfree",
                             "alibaba-exp5-ladder", "alibaba-exp5-ladder-hard",
                             "stream-cg-8k", "stream-cg-8k-batch", "serve-cg-4t",
                             "capture-8k", "adapt-burst-60", "kde-async-8k",
                             "stream-cg-4k-fill4"))
    ap.add_argument("--part", default="both", choices=("both", "shared", "alone", "alone1"),
                    help="serve-cg-4t: the shared run, t0 alone under the pump of "
                         "eight windows or of one, or all three")
    ap.add_argument("--traces", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_req", type=int, default=8,
                    help="adapt-burst-60: requests a burst (1024: adapt-burst-60x1024)")
    ap.add_argument("--out", default=None,
                    help="corpus directory of the alibaba configs "
                         "(default: a temporary one)")
    ap.add_argument("--graphs", default=None,
                    help="comma-separated graph numbers of a ladder config")
    ap.add_argument("--rungs", default=None,
                    help="comma-separated compress factors of a ladder config")
    args = ap.parse_args()
    if args.config == "capture-8k":
        capture_config(args.traces)
        return
    if args.config == "adapt-burst-60":
        adapt_config(60, args.n_req)
        return
    if args.config.startswith(("alibaba", "stream", "serve")):
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            if args.config == "serve-cg-4t":
                serve_config(args.out or tmp, args.part)
            elif args.config == "stream-cg-4k-fill4":
                stream_fill4_config(args.out or tmp)
            elif args.config.startswith("stream-cg-8k"):
                stream_config(args.out or tmp, stream=args.config == "stream-cg-8k")
            elif "-ladder" in args.config:
                graphs = (None if args.graphs is None
                          else {int(g) for g in args.graphs.split(",")})
                rungs = (LADDER_RUNGS if args.rungs is None
                         else tuple(float(r) for r in args.rungs.split(",")))
                ladder_config(args.config, args.out or tmp, graphs, rungs)
            else:
                alibaba_configs(args.config, args.out or tmp)
        return
    if args.config == "synth-fleet-8svc":
        probs = synth_fleet_services(args.traces, args.seed)
        stats = {}
        t0 = time.perf_counter()
        out = run_fleet(probs, stats)
        wall = time.perf_counter() - t0
        acc = {p["service"]: accuracy_for_service(o[0], p["truth"], p["in_parts"])
               for p, o in zip(probs, out)}
        keys = ("fleet_dispatches", "fleet_services", "fused_em_applied",
                "fleet_dynamism_dispatches", "compact_windows_total",
                "compact_windows_redispatched")
        print(json.dumps(dict(config=args.config, traces=args.traces,
                              accuracy=acc, wall_s=wall,
                              **{k: stats.get(k, 0.0) for k in keys},
                              backend=jax.default_backend())))
        return
    prob = synth_async_service(args.traces, args.seed)
    kde = args.config == "kde-async-8k"
    algo = WeaverTPU({}, {}, score_mode="kde" if kde else "mixture")
    t0 = time.perf_counter()
    out = algo.FindAssignments(
        "MaxScoreBatchSubsetWithSkips", "svc", prob["in_parts"],
        prob["out_parts"], False, [], prob["truth"], prob["dag"])
    wall = time.perf_counter() - t0
    acc = accuracy_for_service(out[0], prob["truth"], prob["in_parts"])
    print(json.dumps(dict(config=args.config, traces=args.traces,
                          accuracy=acc, wall_s=wall,
                          fused_em_applied=algo.stats.get("fused_em_applied", 0.0),
                          backend=jax.default_backend())))


if __name__ == "__main__":
    main()
