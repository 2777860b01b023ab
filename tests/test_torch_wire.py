"""The port's columnar wire ingest (``traceweaver_tpu_torch/ingest/wire.py``)
against the JAX package's.

- randomized payloads (duplicate span ids, mixed trace ids, string and
  fractional times, missing process ids, malformed spans and traces):
  the port's native front end (the C++ loader's ``tw_parse_payload``) and
  its dict front end accept the same spans, count the same dead letters
  and raise the same errors as the JAX package's object parser and wire
  parse;
- malformed-span counters on the serve path, strict mode, and an
  invalid JSON POST answered 400;
- the native fast path and the careful per-record path agree on the
  Alibaba converter's output; converter payloads go to the object
  parser, counted;
- ``columnar=False`` emits the same bytes.
"""

import json
import random
import threading
import urllib.error
import urllib.request

import pytest

from tests.test_torch_serve import cfg, hotel_payload, raw
from traceweaver_tpu_torch import native
from traceweaver_tpu_torch.ingest import wire
from traceweaver_tpu_torch.serve import TenantService, make_server


def _rand_payload(rng):
    """The JAX package's randomized wire payload (``tests/test_wire.py``)."""
    data = []
    for t in range(rng.randint(0, 4)):
        tid = f"T{t}"
        spans, sids = [], []
        for i in range(rng.randint(0, 6)):
            sid = f"s{i}" if rng.random() > 0.1 or not sids else rng.choice(sids)
            sids.append(sid)
            rec = {
                "traceID": tid if rng.random() > 0.05 else f"X{t}",
                "spanID": sid,
                "startTime": rng.choice([1000 + i, float(1000 + i), str(1000 + i), 1000.5]),
                "duration": rng.choice([50, 50.0, "50"]),
                "operationName": rng.choice(["opA", "HTTP GET /hotels", "init-span"]),
                "processID": rng.choice(["p1", "p2", None]),
                "references": [],
                "tags": [{"key": "span.kind", "value": rng.choice(["server", "client"])}],
            }
            if rec["processID"] is None:
                del rec["processID"]
            if i > 0 and rng.random() > 0.3:
                rec["references"] = [{"traceID": tid,
                                      "spanID": rng.choice(sids[:-1] or [sid])}]
            if rng.random() < 0.05:
                del rec["startTime"]
            if rng.random() < 0.03:
                rec["requestType"] = "rt-op"
            spans.append(rec)
        entry = {"traceID": tid, "spans": spans,
                 "processes": {"p1": {"serviceName": "svcA"},
                               "p2": {"serviceName": "svcB"}}}
        if rng.random() < 0.05:
            del entry["spans"]
        data.append(entry)
    return {"data": data}


def _canon(entries, materialize):
    def num(v):
        try:
            return repr(float(v))
        except (TypeError, ValueError):
            return repr(v)

    out = []
    for e in entries:
        if e is None:
            out.append(None)
            continue
        tid, spans, procs = e.materialize() if materialize else e
        out.append((tid, tuple(sorted(
            (s.sid, s.trace_id, num(s.start_mus), num(s.duration_mus), repr(s.op_name),
             repr(s.references), repr(s.process_id), repr(s.span_kind))
            for s in spans.values())),
            tuple(sorted((str(k), repr(v)) for k, v in (procs or {}).items()))))
    return out


def _run(fn):
    counters = {}
    try:
        return fn(counters), None, counters
    except Exception as e:  # noqa: BLE001 - parity on the error
        return None, f"{type(e).__name__}: {e}", counters


def test_wire_front_ends_match_jax_randomized():
    import traceweaver_tpu.runtime.executor  # noqa: F401 (the ingest cycle)
    from traceweaver_tpu.ingest import wire as jwire
    from traceweaver_tpu.ingest.jaeger import parse_trace_payload

    rng = random.Random(20180)
    engines = set()
    for trial in range(120):
        fix = rng.choice([2, 3, 4, 6])
        body = raw(_rand_payload(rng))
        want = _run(lambda c: _canon(parse_trace_payload(
            json.loads(body), fix, {}, {}, strict=False, counters=c), False))
        jax_wire = _run(lambda c: _canon(jwire.parse_payload_wire(
            body, fix, {}, strict=False, counters=c), True))
        assert jax_wire == want, trial
        for payload in (body, json.loads(body)):
            got = _run(lambda c: _canon(wire.parse_payload_wire(
                payload, fix, {}, strict=False, counters=c), True))
            assert got == want, f"trial {trial} fix={fix} bytes={payload is body}"
        nc = native.parse_payload(body)
        engines.add("native" if nc is not None and not (
            nc.span_malformed.any() or nc.trace_malformed.any()) else "python")
    assert engines == {"native", "python"}


def test_native_fast_and_careful_paths_agree(tmp_path):
    """The Alibaba converter's output (caller fields: the object parser
    owns it) and the same traces stripped of converter fields (the native
    fast path at fix 6, the careful assembler at fix 5)."""
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.ingest.jaeger import parse_trace_payload

    (d,) = synthesize_corpus(str(tmp_path / "cg"), n_graphs=1, traces_per_graph=64,
                             seed=10, base_gap_ms=20)
    import os

    traces = []
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            traces.extend(json.load(f)["data"])
    body = raw({"data": traces})
    assert wire.parse_payload_wire(body, 5, {}) is None   # converter records
    for tr in traces:
        for s in tr["spans"]:
            for k in ("caller", "callee", "interface"):
                s.pop(k, None)
    body = raw({"data": traces})
    for fix in (5, 6):
        c1, c2 = {}, {}
        want = _canon(parse_trace_payload(json.loads(body), fix, {}, {}, counters=c1), False)
        got = _canon(wire.parse_payload_wire(body, fix, {}, counters=c2), True)
        assert got == want and c1 == c2, fix


def test_malformed_counters_on_the_columnar_path_and_strict():
    from traceweaver_tpu_torch.ingest.jaeger import MalformedSpan

    payload = hotel_payload(n_traces=4, prefix="m")
    payload["data"][0]["spans"][1] = {"spanID": "broken"}
    body = raw(payload)
    svc = TenantService(cfg(), device="cpu")
    out = svc.ingest("m", body)
    assert out["malformed_spans"] == 1 and out["ingested_traces"] == 4
    assert svc.tenants["m"].counters.get("wire_columnar_posts") == 1
    ref = TenantService(cfg(columnar=False), device="cpu")
    assert ref.ingest("m", body) == out
    assert ref.tenants["m"].counters.get("wire_object_posts") == 1
    strict = TenantService(cfg(strict=True), device="cpu")
    with pytest.raises(MalformedSpan):
        strict.ingest("m", body)
    assert strict.tenants["m"].counters.get("wire_columnar_posts") is None


def test_columnar_off_emits_identical_bytes(tmp_path):
    out = []
    for columnar in (True, False):
        state = str(tmp_path / str(columnar))
        svc = TenantService(cfg(state_dir=state, columnar=columnar), device="cpu")
        svc.ingest("w", raw(hotel_payload(24)))
        svc.flush()
        svc.drain()
        with open(f"{state}/w/traces.jsonl", "rb") as f:
            out.append(f.read())
    assert out[0] and out[0] == out[1]


def test_invalid_json_post_is_malformed_not_500():
    svc = TenantService(cfg(), device="cpu")
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/api/v1/tenants/j/spans", data=b"{not json",
            method="POST", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        assert "invalid JSON" in json.loads(ei.value.read())["error"]
    finally:
        server.shutdown()
        server.server_close()
