"""Request→thread attribution over recovered HTTP/2 events.

Port of the reference prototype's final analysis stages
(reference: src/span_collector/http2_parser/parser.py:44-68 —
``map_request_to_thread`` via tracing headers — and :543-579, a logistic
regression predicting the downstream-request thread from a one-hot
encoding of the upstream thread): given per-connection event streams with
byte-level thread attribution (from :mod:`.strace`), join incoming
requests to the outgoing requests they caused using propagated tracing
headers (``uber-trace-id``, ``x-request-id``, ``x-b3-*``), then test how
predictable the handling thread is.

Mirrors ``traceweaver_tpu/collector/threading_model.py``; the port keeps its own copy.
The card's machine has no scikit-learn, so the regression is fitted with
scipy on the same objective (:func:`_fit_logistic`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.collector.http2 import Event
from traceweaver_tpu_torch.collector.strace import FdStream

# Headers that propagate request identity (reference parser.py:44-68).
TRACE_HEADERS = (
    "uber-trace-id",
    "x-request-id",
    "x-b3-traceid",
    "x-b3-spanid",
    "x-b3-parentspanid",
)


def request_key(headers: List[Tuple[str, str]]) -> Optional[str]:
    """A stable request identity from tracing headers. ``uber-trace-id``
    carries ``trace:span:parent:flags`` — the trace id joins a service's
    incoming request with the outgoing calls it makes."""
    h = {name.lower(): value for name, value in headers}
    uber = h.get("uber-trace-id")
    if uber:
        return uber.split(":")[0]
    b3 = h.get("x-b3-traceid")
    if b3:
        return b3
    return h.get("x-request-id")


@dataclass
class AttributedRequest:
    """One request event attributed to the thread that carried its bytes."""

    key: Optional[str]
    stream_id: int
    fd: int
    iteration: int
    direction: str          # "in" = received by the process, "out" = sent
    pid: Optional[int]
    headers: List[Tuple[str, str]]
    seq: int                # capture order of the first byte


def attribute_requests(
    streams: Dict[Tuple[int, int], "FdStream"],
    events_by_stream: Dict[Tuple[int, int], Tuple[List[Event], List[Event]]],
) -> List[AttributedRequest]:
    """Join request events back to the pids that read/wrote their frames."""
    out: List[AttributedRequest] = []
    for key, (in_events, out_events) in events_by_stream.items():
        stream = streams[key]
        for direction, events in (("in", in_events), ("out", out_events)):
            ranges = (stream.read_ranges if direction == "in"
                      else stream.write_ranges)
            for ev in events:
                if ev.kind != "request":
                    continue
                pid = stream.pid_at(direction, ev.offset)
                seq = 0
                for r in ranges:
                    if r.start <= ev.offset < r.end:
                        seq = r.seq
                        break
                out.append(AttributedRequest(
                    key=request_key(ev.headers),
                    stream_id=ev.stream_id,
                    fd=stream.fd,
                    iteration=stream.iteration,
                    direction=direction,
                    pid=pid,
                    headers=ev.headers,
                    seq=seq,
                ))
    return out


def join_causal_pairs(
    requests: List[AttributedRequest],
) -> List[Tuple[AttributedRequest, AttributedRequest]]:
    """Pair each incoming request with the outgoing requests sharing its
    tracing identity — the capture-side analogue of the reconstruction
    problem (here the join key is observed, not inferred)."""
    incoming: Dict[str, List[AttributedRequest]] = {}
    for req in requests:
        if req.direction == "in" and req.key:
            incoming.setdefault(req.key, []).append(req)
    pairs = []
    for req in requests:
        if req.direction != "out" or not req.key:
            continue
        for parent in incoming.get(req.key, []):
            pairs.append((parent, req))
    return pairs


def thread_predictability(
    pairs: List[Tuple[AttributedRequest, AttributedRequest]],
) -> Optional[float]:
    """Reference parser.py:543-579: fit a logistic regression predicting the
    downstream (outgoing) thread from a one-hot of the upstream (incoming)
    thread; returns training accuracy, or None with too little data. A high
    score means thread identity alone links requests across a service —
    the hypothesis the vPath baseline encodes."""
    import numpy as np

    data = [(p.pid, c.pid) for p, c in pairs
            if p.pid is not None and c.pid is not None]
    if len(data) < 2:
        return None
    up = sorted({u for u, _ in data})
    down = sorted({d for _, d in data})
    if len(down) == 1:
        return 1.0
    up_idx = {u: i for i, u in enumerate(up)}
    down_idx = {d: i for i, d in enumerate(down)}
    X = np.zeros((len(data), len(up)))
    y = np.zeros(len(data), dtype=int)
    for i, (u, d) in enumerate(data):
        X[i, up_idx[u]] = 1.0
        y[i] = down_idx[d]
    W = _fit_logistic(X, y, len(down))
    Z = X @ W[:-1] + W[-1]
    pred = (Z[:, 0] > 0).astype(int) if len(down) == 2 else np.argmax(Z, axis=1)
    return float(np.mean(pred == y))


def _fit_logistic(X, y, n_classes: int, C: float = 1.0):
    """L2-penalised logistic regression (the JAX package's scikit-learn
    ``LogisticRegression()`` defaults: ``C=1``, unpenalised intercept,
    L-BFGS, binary for two classes and multinomial above), fitted with
    scipy; returns the weights with the intercept as the last row."""
    import numpy as np
    from scipy.optimize import minimize
    from scipy.special import logsumexp

    n, d = X.shape
    k = 1 if n_classes == 2 else n_classes
    Y = np.zeros((n, n_classes))
    Y[np.arange(n), y] = 1.0

    def loss(w):
        W = w.reshape(d + 1, k)
        Z = X @ W[:-1] + W[-1]
        if k == 1:
            z = Z[:, 0]
            t = Y[:, 1]
            f = np.sum(np.logaddexp(0.0, z) - t * z)
            g_z = 1.0 / (1.0 + np.exp(-z)) - t
            G_z = g_z[:, None]
        else:
            lse = logsumexp(Z, axis=1)
            f = np.sum(lse - np.sum(Y * Z, axis=1))
            G_z = np.exp(Z - lse[:, None]) - Y
        f += 0.5 / C * np.sum(W[:-1] ** 2)
        G = np.vstack([X.T @ G_z + W[:-1] / C, G_z.sum(axis=0)[None]])
        return f, G.ravel()

    res = minimize(loss, np.zeros((d + 1) * k), jac=True, method="L-BFGS-B",
                   options=dict(maxiter=1000))
    return res.x.reshape(d + 1, k)
