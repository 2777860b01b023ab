"""Reference accuracy of the JAX package on the port's synthetic configs.

The PyTorch port's ``chip_smoke.py`` holds its on-card accuracy against
these numbers (minus one point). Run on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py [--traces 8192]
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config synth-fleet-8svc
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-15000
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-cg-8k
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-gtfree
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-cg-8k-gtfree

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="synth-async-8k",
                    choices=("synth-async-8k", "synth-fleet-8svc",
                             "alibaba-exp5-15000", "alibaba-cg-8k",
                             "alibaba-exp5-gtfree", "alibaba-cg-8k-gtfree"))
    ap.add_argument("--traces", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="corpus directory of the alibaba configs "
                         "(default: a temporary one)")
    args = ap.parse_args()
    if args.config.startswith("alibaba"):
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
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
    algo = WeaverTPU({}, {})
    t0 = time.perf_counter()
    out = algo.FindAssignments(
        "MaxScoreBatchSubsetWithSkips", "svc", prob["in_parts"],
        prob["out_parts"], False, [], prob["truth"], prob["dag"])
    wall = time.perf_counter() - t0
    acc = accuracy_for_service(out[0], prob["truth"], prob["in_parts"])
    print(json.dumps(dict(config="synth-async-8k", traces=args.traces,
                          accuracy=acc, wall_s=wall,
                          fused_em_applied=algo.stats.get("fused_em_applied", 0.0),
                          backend=jax.default_backend())))


if __name__ == "__main__":
    main()
