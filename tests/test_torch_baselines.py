"""The port's host baselines, exact oracle, load compression and
end-to-end metrics vs the JAX package's (CPU).

The problems are the services of a 256-trace synthesized call graph,
prepared by each package's own executor preamble (ingest, partitions,
ground truth, invocation DAG, load compression at 15000 against the
replica table): WAP5, FCFS, ArrivalOrder, vPath and vPathOld must give
identical assignment dicts; WeaverExact (``MaxScoreBatch``,
``MaxScoreBatchParallel``, ``MaxScore``) too, at compress 1 where its
search stays small. ``compress_spans`` and every end-to-end metric
function must agree exactly.
"""

import copy
import os
import random

import pytest
import torch

import traceweaver_tpu.runtime.executor as jx
from traceweaver_tpu import algorithms as ja
from traceweaver_tpu import metrics as jm
from traceweaver_tpu.algorithms.weaver_exact import WeaverExact
from traceweaver_tpu.alibaba.synthesize import synthesize_corpus
from traceweaver_tpu.synth import compress_spans as j_compress
from traceweaver_tpu.synth import repeat_and_interleave_spans as j_repeat

import traceweaver_tpu_torch.runtime.executor as tx
from traceweaver_tpu_torch import algorithms as ta
from traceweaver_tpu_torch import metrics as tm
from traceweaver_tpu_torch.synth import compress_spans as t_compress
from traceweaver_tpu_torch.synth import repeat_and_interleave_spans as t_repeat

torch.set_num_threads(1)

N_TRACES = 256
HOST = ("WAP5", "FCFS", "ArrivalOrder", "vPath", "vPathOld")
EXACT = ("MaxScoreBatch", "MaxScoreBatchParallel", "MaxScore")
CLASS_OF = {"WAP5": "WAP5", "FCFS": "FCFS", "ArrivalOrder": "ArrivalOrder",
            "vPath": "VPath", "vPathOld": "VPathOld", "MaxScoreBatch": "WeaverExact",
            "MaxScoreBatchParallel": "WeaverExact", "MaxScore": "WeaverExact"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cg")
    (d,) = synthesize_corpus(str(root), n_graphs=1, traces_per_graph=N_TRACES, seed=10)
    return d, jx.load_replica_table(os.path.join(root, "misc",
                                                 "service_to_replica_new.pickle"))


def _stores(corpus):
    d, _ = corpus
    random.seed(10)
    js = jx.load_corpus(d, 5, native="never", cache=False)
    random.seed(10)
    ts = tx.load_corpus(d, 5, cache=False)
    return js, ts


@pytest.fixture(scope="module")
def stores(corpus):
    return _stores(corpus)


def _preps(corpus, stores, compress, method):
    """Each package's executor preamble over every service."""
    _, table = corpus
    js, ts = stores
    kw = dict(data_path="", results_directory="", fix=5, compress_factor=compress,
              service_to_replica=table)
    jcfg, tcfg = jx.ExecutorConfig(**kw), tx.ExecutorConfig(**kw)
    out = []
    for svc in js.out_spans_by_process:
        jp = jx._prepare_service(jcfg, js, method, svc)
        tp = tx._prepare_service(tcfg, ts, method, svc)
        assert (jp is None) == (tp is None)
        if jp is not None:
            out.append((svc, jp, tp))
    assert len(out) >= 3
    return out


def _solve(pkg, store, method, prep, svc):
    cls = WeaverExact if pkg is ja and method in EXACT else getattr(pkg, CLASS_OF[method])
    algo = cls(store.all_spans, store.all_processes)
    prob = prep["prob"]
    parallel = method == "MaxScoreBatchParallel"
    args = [method, svc, prob.in_span_partitions, prob.out_span_partitions,
            parallel, [], prep["true"]]
    if method == "MaxScoreBatchParallel":
        args.append(prep["dag"])
    return algo.FindAssignments(*args)


@pytest.mark.parametrize("method,compress", [(m, 15000) for m in HOST]
                         + [(m, 1) for m in EXACT])
def test_baseline_assignments_identical(corpus, stores, method, compress):
    js, ts = stores
    for svc, jp, tp in _preps(corpus, stores, compress, method):
        jo = _solve(ja, js, method, jp, svc)
        to = _solve(ta, ts, method, tp, svc)
        assert jo == to, (method, svc)
        pred = to[0] if isinstance(to, tuple) else to
        assert set(pred) == set(tp["true"])
        acc_j = jm.accuracy_for_service(jo[0] if isinstance(jo, tuple) else jo,
                                        jp["true"], jp["prob"].in_span_partitions)
        acc_t = tm.accuracy_for_service(pred, tp["true"], tp["prob"].in_span_partitions)
        assert acc_j == acc_t


def test_compress_spans_identical(stores):
    js, ts = stores
    svc = next(s for s in js.out_spans_by_process
               if len(js.out_spans_by_process[s]) > 1)
    jp = jx.build_service_problem(js, svc)
    tp = tx.build_service_problem(ts, svc)
    for factor, repeat in ((15000, 1), (200, 1), (1, 1)):
        jin, jout = copy.deepcopy((jp.in_span_partitions, jp.out_span_partitions))
        tin, tout = copy.deepcopy((tp.in_span_partitions, tp.out_span_partitions))
        j_compress(jin, jout, repeat, factor)
        t_compress(tin, tout, repeat, factor)
        for j, t in ((jin, tin), (jout, tout)):
            assert {e: [(s.GetId(), s.start_mus, s.duration_mus) for s in v]
                    for e, v in j.items()} == \
                {e: [(s.GetId(), s.start_mus, s.duration_mus) for s in v]
                 for e, v in t.items()}


def test_repeat_and_interleave_identical(stores):
    """The replication transform draws from the global ``random``: one
    seed, one result in both packages."""
    js, ts = stores
    svc = next(s for s in js.out_spans_by_process
               if len(js.out_spans_by_process[s]) > 1)
    got = []
    for mod, store, repeat in ((jx, js, j_repeat), (tx, ts, t_repeat)):
        prob = mod.build_service_problem(store, svc)
        random.seed(4)
        ins, outs = repeat(prob.in_span_partitions, prob.out_span_partitions, 3, 200)
        got.append([[(s.trace_id, s.sid, s.start_mus, s.duration_mus) for s in v]
                    for part in (ins, outs) for v in part.values()])
    assert got[0] == got[1]
    assert len(got[1][0]) > N_TRACES


def _span_key(s):
    return None if s is None else (s.trace_id, s.sid, s.start_mus, s.duration_mus,
                                   s.process_id, s.span_kind)


def test_end_to_end_metrics_identical(corpus, stores):
    """FCFS's assignments over every service through each package's
    end-to-end, top-k, binned and trace-assembly functions."""
    js, ts = stores
    got = []
    for pkg, metrics, store, side in ((ja, jm, js, 1), (ta, tm, ts, 2)):
        pred_by, true_by, topk_by = {}, {}, {}
        for svc, jp, tp in _preps(corpus, stores, 15000, "FCFS"):
            prep = (jp, tp)[side - 1]
            pred = _solve(pkg, store, "FCFS", prep, svc)
            pred_by[svc], true_by[svc] = pred, prep["true"]
            # a top-k form: the prediction first, then the truth
            topk_by[svc] = {ep: {i: [o, prep["true"][ep].get(i)] for i, o in m.items()}
                            for ep, m in pred.items()}
            assert metrics.topk_accuracy_for_service(
                topk_by[svc], prep["true"], prep["prob"].in_span_partitions) == 1.0
        trace_acc, acc = metrics.accuracy_end_to_end(pred_by, true_by,
                                                     store.in_spans_by_process)
        tk_acc, tk = metrics.topk_accuracy_end_to_end(topk_by, true_by,
                                                      store.in_spans_by_process)
        bins = metrics.bin_accuracy_by_response_times(trace_acc, store.all_spans)
        true_e2e, pred_e2e = metrics.construct_end_to_end_traces(
            pred_by, true_by, store.in_spans_by_process, store.all_spans)
        got.append((trace_acc, acc, tk_acc, tk, bins,
                    {t: [_span_key(s) for s in v] for t, v in true_e2e.items()},
                    {t: [_span_key(s) for s in v] for t, v in pred_e2e.items()}))
    assert got[0] == got[1]
    assert 0.0 < got[1][1] < 1.0 and got[1][3] == 1.0
