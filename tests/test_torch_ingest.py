"""The port's ingest and Alibaba pipeline vs the JAX package's (CPU).

- both synthesizers on one seed write byte-identical trees (trace files
  and replica table);
- both ``load_corpus`` on one directory give equal stores: span ids,
  times, kinds, parents, process tables, ``service_loop_map``, in/out
  lists and columns (the JAX side with ``native="never"``, the global
  ``random`` seeded alike before each, since ``-loop`` names draw from it);
- ``build_service_problem`` partitions are equal and
  ``infer_invocation_dag`` gives the same edge set (networkx against the
  port's ``dag.DAG``);
- hand-written Jaeger payloads through fix modes 0, 1 and 2, and
  malformed spans: skip-and-count by default, ``strict`` raises;
- ``repair_trace``, ``call_graph_signature``, ``group_traces`` and
  ``split_all`` agree on small records and CSVs.
"""

import copy
import csv
import filecmp
import os
import random

import pytest
import torch

import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
from traceweaver_tpu.alibaba import convert as j_convert
from traceweaver_tpu.alibaba import grouping as j_grouping
from traceweaver_tpu.alibaba.preprocess import split_all as j_split_all
from traceweaver_tpu.alibaba.synthesize import MESSY_DEFAULT as J_MESSY
from traceweaver_tpu.alibaba.synthesize import synthesize_corpus as j_synthesize
from traceweaver_tpu.ingest import jaeger as j_jaeger
from traceweaver_tpu.ingest import build_service_problem as j_problem
from traceweaver_tpu.ingest import infer_invocation_dag as j_dag
from traceweaver_tpu.metrics import get_ground_truth as j_truth

from traceweaver_tpu_torch.alibaba import convert as t_convert
from traceweaver_tpu_torch.alibaba import grouping as t_grouping
from traceweaver_tpu_torch.alibaba.preprocess import split_all as t_split_all
from traceweaver_tpu_torch.alibaba.schema import CallRecord
from traceweaver_tpu_torch.alibaba.synthesize import MESSY_DEFAULT as T_MESSY
from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus as t_synthesize
from traceweaver_tpu_torch.ingest import jaeger as t_jaeger
from traceweaver_tpu_torch.ingest import build_service_problem as t_problem
from traceweaver_tpu_torch.ingest import infer_invocation_dag as t_dag
from traceweaver_tpu_torch.metrics import get_ground_truth as t_truth

torch.set_num_threads(1)

N_GRAPHS, N_TRACES = 3, 96


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus from each package's synthesizer, with the messy
    defect profile so repair runs on real defects."""
    root = tmp_path_factory.mktemp("alibaba")
    j_dirs = j_synthesize(str(root / "jax"), n_graphs=N_GRAPHS,
                          traces_per_graph=N_TRACES, seed=10, messy=J_MESSY)
    t_dirs = t_synthesize(str(root / "torch"), n_graphs=N_GRAPHS,
                          traces_per_graph=N_TRACES, seed=10, messy=T_MESSY)
    return root, j_dirs, t_dirs


def _load_both(directory, fix=5, **kw):
    random.seed(10)
    js = j_jaeger.load_corpus(directory, fix, native="never", cache=False, **kw)
    random.seed(10)
    ts = t_jaeger.load_corpus(directory, fix, cache=False, **kw)
    return js, ts


def _span_fields(s):
    return (s.trace_id, s.sid, s.start_mus, s.duration_mus, s.op_name,
            list(s.references), s.process_id, s.span_kind,
            list(s.children_spans))


def _assert_stores_equal(js, ts):
    assert list(js.all_spans) == list(ts.all_spans)
    for k in js.all_spans:
        assert _span_fields(js.all_spans[k]) == _span_fields(ts.all_spans[k])
    assert js.all_processes == ts.all_processes
    assert js.service_loop_map == ts.service_loop_map
    assert js.ingest_counters == ts.ingest_counters
    for attr in ("in_spans_by_process", "out_spans_by_process"):
        j, t = getattr(js, attr), getattr(ts, attr)
        assert list(j) == list(t)
        assert {p: [s.GetId() for s in v] for p, v in j.items()} == \
            {p: [s.GetId() for s in v] for p, v in t.items()}
    assert list(js.columns) == list(ts.columns)
    for svc, cols in js.columns.items():
        for key in ("in", "out"):
            a, b = cols[key], ts.columns[svc][key]
            assert a.start.tolist() == b.start.tolist()
            assert a.end.tolist() == b.end.tolist()
            assert a.ids.tolist() == b.ids.tolist()
            assert a.service.tolist() == b.service.tolist()
            assert a.service_table == b.service_table


def test_synthesizers_write_identical_trees(corpora):
    root, j_dirs, t_dirs = corpora
    assert [os.path.basename(d) for d in j_dirs] == [os.path.basename(d) for d in t_dirs]
    jt, tt = _tree(root / "jax"), _tree(root / "torch")
    assert sorted(jt) == sorted(tt)
    assert any(k.endswith("service_to_replica_new.pickle") for k in jt)
    assert len(jt) > N_GRAPHS * N_TRACES // 2
    differ = [k for k in jt if not filecmp.cmp(jt[k], tt[k], shallow=False)]
    assert not differ


@pytest.mark.parametrize("graph", range(N_GRAPHS))
def test_load_corpus_partitions_and_dags_equal(corpora, graph):
    _, j_dirs, _ = corpora
    js, ts = _load_both(j_dirs[graph])
    _assert_stores_equal(js, ts)
    assert js.in_spans_by_process
    n_solvable = 0
    for svc in js.out_spans_by_process:
        jp, tp = j_problem(js, svc), t_problem(ts, svc)
        assert (jp.skipped, jp.skip_reason) == (tp.skipped, tp.skip_reason)
        for attr in ("in_span_partitions", "out_span_partitions"):
            j, t = getattr(jp, attr), getattr(tp, attr)
            assert list(j) == list(t)
            assert {e: [_span_fields(s) for s in v] for e, v in j.items()} == \
                {e: [_span_fields(s) for s in v] for e, v in t.items()}
        if jp.skipped:
            continue
        n_solvable += 1
        jt = j_truth(jp.in_span_partitions, jp.out_span_partitions)
        tt = t_truth(tp.in_span_partitions, tp.out_span_partitions)
        assert jt == tt
        jg = j_dag(jp.in_span_partitions, jp.out_span_partitions, jt, js)
        tg = t_dag(tp.in_span_partitions, tp.out_span_partitions, tt, ts)
        assert list(jg.nodes) == list(tg)
        assert list(jg.edges()) == tg.edges()
    assert n_solvable


def test_load_corpus_cap_and_time_order(corpora):
    _, j_dirs, _ = corpora
    js, ts = _load_both(j_dirs[0], max_traces=20)
    _assert_stores_equal(js, ts)
    assert len(ts.all_processes) == 21  # the reference's cap: max + 1
    assert j_jaeger.time_ordered_trace_files(j_dirs[0], cache=False) == \
        t_jaeger.time_ordered_trace_files(j_dirs[0], cache=False)


def test_time_order_cache_is_read_by_the_other_package(tmp_path, corpora):
    _, j_dirs, _ = corpora
    d = tmp_path / "cg"
    d.mkdir()
    for f in sorted(os.listdir(j_dirs[1]))[:12]:
        (d / f).write_bytes(open(os.path.join(j_dirs[1], f), "rb").read())
    written = j_jaeger.time_ordered_trace_files(str(d), write_cache=True)
    assert (d / "time_order_filenames.pickle").exists()
    assert t_jaeger.time_ordered_trace_files(str(d)) == written


# ---------------------------------------------------------------------------
# hand-written payloads
# ---------------------------------------------------------------------------

def _span(tid, sid, start, dur, op, kind, pid, parent=None, **extra):
    rec = {"traceID": tid, "spanID": sid, "startTime": start, "duration": dur,
           "operationName": op, "processID": pid,
           "tags": [{"key": "span.kind", "value": kind}],
           "references": [] if parent is None else
           [{"refType": "CHILD_OF", "traceID": tid, "spanID": parent}]}
    rec.update(extra)
    return rec


def _payload(fix):
    if fix == 0:  # nodejs: one span per call, the caller half missing
        spans = [_span("t0", "a", 0, 100, "init-span", "client", "p1"),
                 _span("t0", "b", 10, 50, "call", "server", "p2", "a"),
                 _span("t0", "c", 20, 20, "call", "server", "p3", "b")]
        procs = {"p1": "init-service", "p2": "service1", "p3": "service2"}
    elif fix == 1:  # media: re-rooted at ComposeReview
        spans = [_span("t1", "g", 0, 200, "nginx", "server", "p0"),
                 _span("t1", "r", 5, 150, "ComposeReview", "server", "p1", "g"),
                 _span("t1", "x", 10, 50, "upload", "server", "p2", "r"),
                 _span("t1", "y", 12, 30, "inner", "server", "p2", "x"),
                 _span("t1", "z", 70, 40, "store", "server", "p3", "r")]
        procs = {"p0": "nginx", "p1": "compose", "p2": "text", "p3": "store"}
    else:  # hotel: client/server pairs under HTTP GET /hotels
        spans = [_span("t2", "r", 0, 100, "HTTP GET /hotels", "server", "p1"),
                 _span("t2", "c1", 10, 30, "search", "client", "p1", "r"),
                 _span("t2", "s1", 12, 25, "search", "server", "p2", "c1"),
                 _span("t2", "c2", 50, 30, "profile", "client", "p1", "r"),
                 _span("t2", "s2", 52, 25, "profile", "server", "p3", "c2")]
        procs = {"p1": "frontend", "p2": "search", "p3": "profile"}
    return {"data": [{"traceID": spans[0]["traceID"], "spans": spans,
                      "processes": {p: {"serviceName": n} for p, n in procs.items()}}]}


def _parsed(mod, payload, fix, **kw):
    counters = {}
    out = mod.parse_trace_payload(copy.deepcopy(payload), fix, {}, {},
                                  counters=counters, **kw)
    return [None if r is None else
            (r[0], {k: _span_fields(s) for k, s in r[1].items()}, r[2])
            for r in out], counters


@pytest.mark.parametrize("fix", [0, 1, 2])
def test_fix_modes_equal(fix):
    payload = _payload(fix)
    j, jc = _parsed(j_jaeger, payload, fix)
    t, tc = _parsed(t_jaeger, payload, fix)
    assert j == t and jc == tc
    assert t[0] is not None and len(t[0][1]) >= 3


def test_malformed_spans_skip_and_count_or_raise():
    payload = _payload(2)
    bad = payload["data"][0]["spans"]
    bad.append({"traceID": "t2", "spanID": "broken"})  # no times, no process
    bad.append(_span("t2", "nan", "soon", 5, "x", "client", "p1", "r"))
    payload["data"].append({"spans": []})  # no traceID
    j, jc = _parsed(j_jaeger, payload, 2)
    t, tc = _parsed(t_jaeger, payload, 2)
    assert j == t and jc == tc
    assert tc == {"malformed_spans": 2, "malformed_traces": 1}
    for mod in (j_jaeger, t_jaeger):
        with pytest.raises(mod.MalformedSpan):
            mod.parse_trace_payload(copy.deepcopy(payload), 2, {}, {}, strict=True)
    with pytest.raises(t_jaeger.MalformedSpan):
        t_jaeger.parse_trace_payload({"spans": []}, 2, {}, {})


def test_ingest_trace_and_root_filter_equal():
    from traceweaver_tpu.spans import TraceStore as JStore

    from traceweaver_tpu_torch.spans import TraceStore as TStore

    payload = _payload(2)
    other = _payload(2)
    other["data"][0]["spans"][0]["operationName"] = "HTTP GET /other"
    kept = []
    for mod, store in ((j_jaeger, JStore()), (t_jaeger, TStore())):
        n = 0
        for p in (payload, other):
            tid, spans, procs = mod.parse_trace_payload(p, 2, {}, {})[0]
            n += mod.ingest_trace(store, tid, spans, procs, 2)
        kept.append((n, {k: [s.GetId() for s in v]
                         for k, v in store.in_spans_by_process.items()},
                     {k: [s.GetId() for s in v]
                      for k, v in store.out_spans_by_process.items()}))
    assert kept[0] == kept[1]
    assert kept[1][0] == 1


# ---------------------------------------------------------------------------
# the Alibaba pipeline pieces
# ---------------------------------------------------------------------------

def _records(n_traces=6, seed=3):
    rng = random.Random(seed)
    out = []
    for t in range(n_traces):
        tid = f"t{t}"
        recs = [CallRecord(tid, 1000 + t, "0", "USER", "rpc", "A", "if", 30)]
        for i, (rpc, caller, callee) in enumerate(
                [("0.1", "A", "B"), ("0.2", "A", "C"), ("0.1.1", "B", "D")]):
            recs.append(CallRecord(tid, 1001 + t + i, rpc, caller, "rpc", callee,
                                   "if", rng.randint(1, 9)))
        if t % 2:
            recs[1].caller = "(?)"  # repairable from the parent
            recs.append(CallRecord(tid, 1002, "0.2", "A", "rpc", "C", "if",
                                   -recs[2].rt_ms))  # mirrored duplicate
        if t == 4:
            recs.append(CallRecord(tid, 1003, "0.9.9", "X", "rpc", "Y", "if", 2))
        rng.shuffle(recs)
        out.append(recs)
    return out


def _as_rows(recs):
    return None if recs is None else [r.to_row() for r in recs]


def test_repair_convert_signature_equal():
    from traceweaver_tpu.alibaba.schema import CallRecord as JRecord

    for recs in _records():
        j_recs = [JRecord(**vars(r)) for r in copy.deepcopy(recs)]
        jr = j_convert.repair_trace(j_recs)
        tr = t_convert.repair_trace(copy.deepcopy(recs))
        assert _as_rows(jr) == _as_rows(tr)
        if tr is None:
            continue
        assert j_convert.convert_trace_to_jaeger(jr) == t_convert.convert_trace_to_jaeger(tr)
        assert j_grouping.call_graph_signature(jr) == t_grouping.call_graph_signature(tr)


def test_group_traces_equal(tmp_path):
    from traceweaver_tpu.alibaba.schema import CallRecord as JRecord

    traces = {}
    for recs in _records(8):
        fixed = t_convert.repair_trace(recs)
        if fixed is not None:
            traces[fixed[0].trace_id] = fixed
    j_traces = {k: [JRecord(**vars(r)) for r in v] for k, v in traces.items()}
    jd = j_grouping.group_traces(j_traces, str(tmp_path / "j"), top_n=3, min_traces=1)
    td = t_grouping.group_traces(traces, str(tmp_path / "t"), top_n=3, min_traces=1)
    assert [os.path.basename(d) for d in jd] == [os.path.basename(d) for d in td]
    jt, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert sorted(jt) == sorted(tt) and jt
    assert all(filecmp.cmp(jt[k], tt[k], shallow=False) for k in jt)


def test_split_all_equal(tmp_path):
    header = ["", "traceid", "timestamp", "rpcid", "um", "rpctype", "dm",
              "interface", "rt"]
    shards = []
    for k in range(3):
        path = tmp_path / f"MSCallGraph_{k}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for i in range(5):  # trace t1 straddles every shard
                tid = "t1" if i == 0 else f"t{k}_{i}"
                w.writerow([str(i), tid, str(100 * k + i), "0.%d" % i, "U",
                            "rpc", "A", "if", "5"])
        shards.append(str(path))
    nj = j_split_all(shards, str(tmp_path / "j"), lookback=1)
    nt = t_split_all(shards, str(tmp_path / "t"), lookback=1)
    assert nj == nt
    jt, tt = _tree(tmp_path / "j"), _tree(tmp_path / "t")
    assert sorted(jt) == sorted(tt) and jt
    assert all(filecmp.cmp(jt[k], tt[k], shallow=False) for k in jt)


def test_span_helpers_equal():
    """``Span.fast``, the skip-span wire shape and the columnar reorders
    against the JAX package's."""
    import numpy as np

    from traceweaver_tpu import spans as js
    from traceweaver_tpu_torch import spans as ts

    args = ("t", "s", 5.0, 2.0, "op", [("t", "p")], "proc", "client")
    for mod in (js, ts):
        a, b = mod.Span(*args), mod.Span.fast(*args)
        assert vars(a) == vars(b)
        skip = mod.make_skip_span("x")
        assert mod.is_skip_span(skip) and not mod.is_skip_span(a)
    assert js.skip_span_wire(js.make_skip_span("x")) == \
        ts.skip_span_wire(ts.make_skip_span("x"))
    starts = [3.0, 1.0, 3.0, 2.0, 1.0]
    durs = [1.0, 4.0, 0.5, 1.0, 4.0]
    cols = []
    for mod in (js, ts):
        sp = [mod.Span(f"t{i}", f"s{i}", st, d, None, [], "p", "server")
              for i, (st, d) in enumerate(zip(starts, durs))]
        arr = mod.SpanArray.from_spans(sp)
        arr.service = np.arange(len(sp), dtype=np.int32)
        out = arr.sorted_by_start_end()
        sub = arr.take(np.array([4, 0]))
        cols.append((out.start.tolist(), out.end.tolist(), out.ids.tolist(),
                     out.service.tolist(), out.trace_ids.tolist(), out.sids.tolist(),
                     sub.ids.tolist(), sub.service.tolist()))
    assert cols[0] == cols[1]
    assert cols[1][2] == [("t1", "s1"), ("t4", "s4"), ("t3", "s3"), ("t2", "s2"),
                          ("t0", "s0")]
