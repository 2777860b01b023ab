"""Reference accuracy of the JAX package on config ``synth-async-8k``.

The PyTorch port's ``chip_smoke.py`` holds its on-card accuracy against
this number (minus one point). Run on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_reference_synth.py [--traces 8192]

Prints one JSON line: accuracy, wall seconds, and the solver's
``fused_em_applied`` flag. The input is the repo's synthetic labelled
service (``metrics/scorecard.py _make_service``) with the endpoints made
a chain, exactly as ``traceweaver_tpu_torch.metrics.synth`` builds it.
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
from traceweaver_tpu.metrics.scorecard import _make_service  # noqa: E402


def synth_async_service(n_traces: int, seed: int = 0):
    """``synth-async-8k`` at ``n_traces`` (8192 is the config's size)."""
    prob = _make_service("svc", n_traces=n_traces, n_eps=3,
                         rng=np.random.default_rng(seed), spacing_us=6000.0,
                         burst=n_traces, jitter_us=10.0)
    dag = nx.DiGraph()
    dag.add_nodes_from(prob["out_parts"])
    dag.add_edges_from([("svc-ep0", "svc-ep1"), ("svc-ep1", "svc-ep2")])
    prob["dag"] = dag
    return prob


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
