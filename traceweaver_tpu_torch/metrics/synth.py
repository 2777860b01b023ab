"""Synthetic labelled service (mirrors ``traceweaver_tpu/metrics/scorecard.py
_make_service``).

Same arguments in the same order and the same RNG calls, so one seed
gives the same spans as the JAX copy. ``dag_edges`` adds edges to the
invocation DAG (the JAX copy returns the endpoints with no edges).

Config ``synth-async-8k`` — the slice's full-size input — is
:func:`synth_async_8k`: 8192 requests, three endpoints in a chain, 40 µs
arrivals under 900 µs spans (about 22 requests in flight at once).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from traceweaver_tpu_torch.dag import DAG
from traceweaver_tpu_torch.metrics.accuracy import get_ground_truth
from traceweaver_tpu_torch.spans import Span


def make_service(svc: str, n_traces: int, n_eps: int, rng,
                 spacing_us: float, burst: int, jitter_us: float,
                 dag_edges: Optional[Sequence[Tuple[str, str]]] = None) -> Dict:
    """One service problem: ``n_traces`` requests on a burst/gap arrival
    pattern, each calling ``n_eps`` endpoints at jittered offsets.
    ``burst`` requests share one arrival cluster (40 µs apart); clusters
    are ``spacing_us`` apart."""
    in_spans: List[Span] = []
    out_parts: Dict[str, List[Span]] = {f"{svc}-ep{e}": []
                                        for e in range(n_eps)}
    t = 0.0
    dur = 900.0
    for i in range(n_traces):
        t += 40.0 if (burst > 1 and i % burst) else spacing_us
        tid = f"{svc}-{i:04d}"
        s_in = Span(tid, "in", t, dur, "op", [], svc, "server")
        in_spans.append(s_in)
        for e in range(n_eps):
            base = 30.0 + 90.0 * e
            start = t + base + float(rng.normal(0.0, jitter_us))
            out = Span(tid, f"c{e}", max(start, t + 1.0), 40.0,
                       f"call{e}", [(tid, "in")], svc, "client")
            out_parts[f"{svc}-ep{e}"].append(out)
    for ep in out_parts:
        out_parts[ep].sort(key=lambda s: (s.start_mus, s.sid))
    in_parts = {f"client_{svc}": in_spans}
    truth = get_ground_truth(in_parts, out_parts)
    dag = DAG.from_edges(out_parts.keys(), dag_edges or ())
    return dict(service=svc, in_parts=in_parts, out_parts=out_parts,
                truth=truth, dag=dag)


def chain_edges(svc: str, n_eps: int) -> List[Tuple[str, str]]:
    """``svc-ep0 -> svc-ep1 -> ...``"""
    return [(f"{svc}-ep{e}", f"{svc}-ep{e + 1}") for e in range(n_eps - 1)]


def synth_async_8k(n_traces: int = 8192, seed: int = 0) -> Dict:
    """Config ``synth-async-8k`` (``n_traces`` cuts it for tests)."""
    return make_service("svc", n_traces=n_traces, n_eps=3,
                        rng=np.random.default_rng(seed), spacing_us=6000.0,
                        burst=n_traces, jitter_us=10.0,
                        dag_edges=chain_edges("svc", 3))
