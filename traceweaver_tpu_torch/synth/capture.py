"""The capture and adaptation corpora, built in process (mirrors
``bench.py``'s ``_capture_workload`` and ``_adapt_burst_events``).

:func:`capture_workload` writes the ``strace -f -ttt`` logs of an
uninstrumented frontend -> search HTTP/2 workload, one log per capture
host, for the capture ingress (``collector:`` sources and the serve
tier's ``/capture`` route). :func:`adapt_burst_events` builds the bursty
frontend -> search span stream whose call latency shifts mid-stream, the
corpus on which the adaptation ladder must recover
(:mod:`traceweaver_tpu_torch.adapt`). Both are byte-equal to the JAX
package's generators for the same arguments, so ``chip_smoke.py`` needs
no ``bench.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def capture_workload(n_traces: int, churn_at: Optional[int] = None) -> Dict[str, str]:
    """Per-source ``strace -f -ttt`` logs (``bench.py
    _capture_workload``): the frontend's capture sees the client requests
    (fd 7) and its downstream calls (fd 9); the search host's capture (its
    own clock) sees the server side (fd 5). Traces are 10 ms apart, and
    tracing headers carry the ground-truth join (grading only; the solver
    reconstructs from timing). ``churn_at`` (default ``n_traces // 2``,
    at least 2) reconnects the frontend's inbound connection mid-capture
    without a ``close``: the ingress must re-key on the fresh preface.
    Returns ``{"frontend": log, "search": log}``."""
    from traceweaver_tpu_torch.collector.hpack import Encoder
    from traceweaver_tpu_torch.collector.http2 import (
        FLAG_END_HEADERS,
        FLAG_END_STREAM,
        HEADERS,
        PREFACE,
        SETTINGS,
    )

    def frame(ftype, flags, stream_id, payload):
        return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
                + stream_id.to_bytes(4, "big") + payload)

    def req(enc, stream_id, path, authority, key):
        block = enc.encode([
            (":method", "POST"), (":scheme", "http"), (":path", path),
            (":authority", authority),
            ("uber-trace-id", f"{key}:1:0:1"),
        ])
        return frame(HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM,
                     stream_id, block)

    def resp(enc, stream_id):
        return frame(HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM,
                     stream_id, enc.encode([(":status", "200")]))

    def esc(data):
        out = []
        for i, b in enumerate(data):
            if b == 0x22:
                out.append('\\"')
            elif b == 0x5C:
                out.append("\\\\")
            elif 0x20 <= b < 0x7F:
                out.append(chr(b))
            else:
                nxt = data[i + 1] if i + 1 < len(data) else None
                out.append(("\\%03o" if nxt is not None
                            and 0x30 <= nxt <= 0x37 else "\\%o") % b)
        return "".join(out)

    def line(pid, ts, op, fd, data):
        return (f'{pid} {ts:.6f} {op}({fd}, "{esc(data)}", {len(data)}) '
                f'= {len(data)}')

    if churn_at is None:
        churn_at = max(2, n_traces // 2)
    fe, se = [], []
    enc = {k: Encoder() for k in ("c_in", "fe_out", "fe_resp",
                                  "dn_resp", "se_in", "se_resp")}
    base = 1_722_000_000.0
    hello = PREFACE + frame(SETTINGS, 0, 0, b"")
    fe.append(line(10, base, "read", 7, hello))
    fe.append(line(10, base, "write", 9, hello))
    se.append(line(20, base, "read", 5, hello))
    sid_in = 0
    for i in range(n_traces):
        if i == churn_at:
            # reconnect without close: a fresh preface and fresh HPACK
            # contexts on fd 7, mid-capture
            sid_in = 0
            enc["c_in"], enc["fe_resp"] = Encoder(), Encoder()
            fe.append(line(10, base + 0.5 + i * 0.01, "read", 7, hello))
        key = f"t{i:04d}"
        sid_in += 2
        sid_dn = 2 * i + 1
        # jittered service delay, so the solver sees a real distribution
        d = 0.002 + (i % 5) * 0.0004
        t0 = base + 0.5 + i * 0.01
        t1 = t0 + 0.001
        t2 = t1 + 0.0002
        t3 = t2 + d
        t4 = t3 + 0.0003
        t5 = t4 + 0.0005
        fe.append(line(10, t0, "read", 7,
                       req(enc["c_in"], sid_in - 1, "/hotels", "frontend", key)))
        fe.append(line(10, t1, "write", 9,
                       req(enc["fe_out"], sid_dn, "/search", "search", key)))
        se.append(line(20, t2, "read", 5,
                       req(enc["se_in"], sid_dn, "/search", "search", key)))
        se.append(line(20, t3, "write", 5, resp(enc["se_resp"], sid_dn)))
        fe.append(line(10, t4, "read", 9, resp(enc["dn_resp"], sid_dn)))
        fe.append(line(10, t5, "write", 7, resp(enc["fe_resp"], sid_in - 1)))
    return {"frontend": "\n".join(fe), "search": "\n".join(se)}


def adapt_burst_events(n_bursts: int, shift_at: int, n_req: int = 8,
                       gap_us: float = 800.0, pre_delay: float = 150.0,
                       post_delay: float = 950.0, seed: int = 7
                       ) -> Tuple[List, int]:
    """The shifted burst corpus (``bench.py _adapt_burst_events``):
    ``n_bursts`` bursts 1 s apart of ``n_req`` frontend -> search
    requests ``gap_us`` apart, whose call delay swaps from ``pre_delay``
    to ``post_delay`` (plus seeded jitter of +-20 us) at burst
    ``shift_at``. The post-shift delay is about one gap plus the old
    delay, so under the stale priors every call matches its neighbour's
    request (slot aliasing), and each burst's last request is a cache hit
    (no call) whose skip makes the wrong matching total: a
    self-consistent wrong equilibrium that a cold order-statistics refit
    breaks. Returns ``(events, n_req)``, the events in arrival order."""
    import numpy as np

    from traceweaver_tpu_torch.spans import Span
    from traceweaver_tpu_torch.stream.sources import SpanEvent

    rng = np.random.default_rng(seed)
    procs = {"p1": "frontend", "p2": "search"}
    events = []
    for b in range(n_bursts):
        base = b * 1e6 + 1000.0
        delay = pre_delay if b < shift_at else post_delay
        for i in range(n_req):
            t = base + i * gap_us
            tid = f"b{b:03d}r{i:02d}"
            d = delay + float(rng.integers(-20, 21))
            spans = [Span(tid, "root", t, 2600.0, "req", [], "p1", "server")]
            if i < n_req - 1:  # the burst's last request is a cache hit
                spans += [
                    Span(tid, "c", t + d, 150.0, "call",
                         [(tid, "root")], "p1", "client"),
                    Span(tid, "s", t + d + 10, 100.0, "search",
                         [(tid, "c")], "p2", "server"),
                ]
            for sp in spans:
                events.append(SpanEvent(
                    span=sp, event_us=float(sp.start_mus),
                    arrival_us=float(sp.start_mus), trace_id=tid,
                    processes=procs))
    events.sort(key=lambda e: (e.arrival_us, e.trace_id, e.span.sid))
    return events, n_req


def adapt_window_accuracies(sink_lines, n_req: int) -> Dict[int, float]:
    """Per-window accuracy of an ``adapt-burst`` stream's sink records
    (``bench.py run_adapt_leg``'s grading): each frontend -> search row
    is right when a call is assigned its own trace's request and the
    burst's last request (the cache hit) is assigned no call. Returns
    ``{window: accuracy}`` over the windows with rows."""
    import json

    skip_sid = "r%02d" % (n_req - 1)
    accs: Dict[int, float] = {}
    for line in sink_lines:
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
