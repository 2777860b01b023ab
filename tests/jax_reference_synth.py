"""Reference accuracy of the JAX package on the port's synthetic configs.

The PyTorch port's ``chip_smoke.py`` holds its on-card accuracy against
these numbers (minus one point). Run on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py [--traces 8192]
    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config synth-fleet-8svc

``synth-async-8k`` (the default) runs ``WeaverTPU.FindAssignments`` and
prints one JSON line: accuracy, wall seconds and the solver's
``fused_em_applied`` flag. ``synth-fleet-8svc`` runs ``solve_fleet`` over
the eight services and prints one JSON line with each service's
accuracy and the fleet's dispatch counters. The inputs are the repo's
synthetic labelled services (``metrics/scorecard.py _make_service`` and
``synth_labeled_corpus``, ``synth/transforms.py create_cache_hits``),
built exactly as ``traceweaver_tpu_torch.metrics.synth`` builds them.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="synth-async-8k",
                    choices=("synth-async-8k", "synth-fleet-8svc"))
    ap.add_argument("--traces", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
