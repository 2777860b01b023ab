"""The port's C++ Jaeger loader against its Python front end and the JAX
package (CPU; ``g++`` builds the loader at first use).

- ``load_corpus`` with ``native=True`` (the C++ loader) and
  ``native=False`` give equal stores, and both equal the JAX
  package's pure-Python ``load_corpus``: span ids and fields, process
  tables, ``service_loop_map`` (the ``-loop`` names draw from the global
  ``random`` in one order), dead-letter counters, in/out lists and
  columns; on the synthesized exp5 corpus (3 graphs x 200 traces, seed
  10), with the ``max_traces`` cut, and on the hand-written fix-mode and
  malformed payloads of ``tests/test_torch_ingest.py``, strict and not;
- the time-ordered listing and ``root_start_time`` equal JAX's;
- no quiet fallback: a loader that fails to compile, a file that is not
  JSON, and a ``native=`` that is not a bool (the JAX package's
  ``"auto"``/``"never"``) raise.

The ``gpu`` test loads a corpus both ways on the card's machine (run
with ``--noconftest``: this module imports JAX only inside its CPU
tests).
"""

import copy
import json
import os
import random

import pytest

from traceweaver_tpu_torch import native
from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
from traceweaver_tpu_torch.ingest import jaeger as t_jaeger

N_GRAPHS, N_TRACES = 3, 200
gpu = pytest.mark.gpu


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp5")
    return synthesize_corpus(str(root), n_graphs=N_GRAPHS,
                             traces_per_graph=N_TRACES, seed=10)


def _span_fields(s):
    return (s.trace_id, s.sid, s.start_mus, s.duration_mus, s.op_name,
            list(s.references), s.process_id, s.span_kind,
            list(s.children_spans))


def _assert_stores_equal(a, b):
    """Equal stores (of either package): spans, process tables, loop
    map, counters, in/out lists and columns."""
    assert list(a.all_spans) == list(b.all_spans)
    for k in a.all_spans:
        assert _span_fields(a.all_spans[k]) == _span_fields(b.all_spans[k])
    assert a.all_processes == b.all_processes
    assert a.service_loop_map == b.service_loop_map
    assert a.ingest_counters == b.ingest_counters
    for attr in ("in_spans_by_process", "out_spans_by_process"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert {p: [s.GetId() for s in v] for p, v in x.items()} == \
            {p: [s.GetId() for s in v] for p, v in y.items()}
        assert list(x) == list(y)
    assert list(a.columns) == list(b.columns)
    for svc, cols in a.columns.items():
        for key in ("in", "out"):
            x, y = cols[key], b.columns[svc][key]
            assert x.start.tolist() == y.start.tolist()
            assert x.end.tolist() == y.end.tolist()
            assert x.ids.tolist() == y.ids.tolist()
            assert x.service_table == y.service_table


def _load(mod, directory, fix, **kw):
    random.seed(10)
    return mod.load_corpus(directory, fix, cache=False, **kw)


def _three(directory, fix=5, **kw):
    """The JAX package's Python front end, the port's native and the
    port's Python front end, each after ``random.seed(10)``."""
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.ingest import jaeger as j_jaeger

    return (_load(j_jaeger, directory, fix, native="never", **kw),
            _load(t_jaeger, directory, fix, native=True, **kw),
            _load(t_jaeger, directory, fix, native=False, **kw))


@pytest.mark.parametrize("graph", range(N_GRAPHS))
def test_front_ends_equal_on_exp5_corpus(corpus, graph):
    js, nat, py = _three(corpus[graph])
    assert (nat.ingest_front_end, py.ingest_front_end) == ("native", "python")
    _assert_stores_equal(js, nat)
    _assert_stores_equal(js, py)
    assert len(nat.all_processes) == N_TRACES and nat.in_spans_by_process


@pytest.mark.parametrize("max_traces", [0, 20, 150])
def test_max_traces_cuts_at_the_same_trace(corpus, max_traces):
    js, nat, py = _three(corpus[1], max_traces=max_traces)
    _assert_stores_equal(js, nat)
    _assert_stores_equal(js, py)
    assert len(nat.all_processes) == max_traces + 1


def test_time_order_and_root_start_time_equal(corpus):
    import traceweaver_tpu.runtime.executor  # noqa: F401
    from traceweaver_tpu.ingest import jaeger as j_jaeger

    d = corpus[0]
    listing = j_jaeger.time_ordered_trace_files(d, cache=False)
    assert t_jaeger.time_ordered_trace_files(d, cache=False) == listing
    assert t_jaeger.time_ordered_trace_files(d, cache=False, native=False) == listing
    for f in listing[:40]:
        ref = j_jaeger._root_start_time(f)
        assert native.root_start_time(f) == ref
        assert t_jaeger._root_start_time(f, native=False) == ref


def _write(directory, payloads):
    os.makedirs(directory, exist_ok=True)
    for i, p in enumerate(payloads):
        with open(os.path.join(directory, f"trace_{i}.json"), "w") as f:
            json.dump(p, f)
    return str(directory)


def _malformed():
    from tests.test_torch_ingest import _payload, _span

    payload = _payload(2)
    bad = payload["data"][0]["spans"]
    bad.append({"traceID": "t2", "spanID": "broken"})  # no times, no process
    bad.append(_span("t2", "nan", "soon", 5, "x", "client", "p1", "r"))
    bad.append(dict(_span("t2", "noref", 3, 5, "x", "client", "p1"),
                    references=[{"traceID": "t2"}]))
    payload["data"].append({"spans": []})  # no traceID
    return payload


def _shifted(payload, k):
    """``payload`` as another trace, ``k`` ms later."""
    p = copy.deepcopy(payload)
    for trace in p["data"]:
        if "traceID" in trace:
            trace["traceID"] += f"-{k}"
        for s in trace.get("spans", []):
            s["traceID"] = s.get("traceID", "") + f"-{k}"
            if isinstance(s.get("startTime"), int):
                s["startTime"] += 1000 * k
            for r in s.get("references", []):
                if "traceID" in r:
                    r["traceID"] += f"-{k}"
    return p


@pytest.mark.parametrize("fix", [0, 1, 2])
def test_front_ends_equal_on_fix_mode_payloads(tmp_path, fix):
    from tests.test_torch_ingest import _payload

    d = _write(tmp_path / "c", [_shifted(_payload(fix), k) for k in range(4)])
    js, nat, py = _three(d, fix=fix)
    _assert_stores_equal(js, nat)
    _assert_stores_equal(js, py)
    assert nat.all_spans


def test_front_ends_equal_on_malformed_payloads(tmp_path):
    from tests.test_torch_ingest import _payload

    d = _write(tmp_path / "m", [_shifted(_malformed(), k) for k in range(3)]
               + [_shifted(_payload(2), 9)])
    js, nat, py = _three(d, fix=2)
    _assert_stores_equal(js, nat)
    _assert_stores_equal(js, py)
    assert nat.ingest_malformed_spans == 9
    assert nat.ingest_counters["malformed_traces"] == 3


def test_strict_raises_on_both_front_ends(tmp_path):
    import traceweaver_tpu.runtime.executor  # noqa: F401
    from traceweaver_tpu.ingest import jaeger as j_jaeger

    d = _write(tmp_path / "s", [_malformed()])
    with pytest.raises(j_jaeger.MalformedSpan):
        _load(j_jaeger, d, 2, native="never", strict=True)
    for front_end in (True, False):
        with pytest.raises(t_jaeger.MalformedSpan):
            _load(t_jaeger, d, 2, native=front_end, strict=True)


def test_unparsable_file_raises(tmp_path):
    from tests.test_torch_ingest import _payload

    d = _write(tmp_path / "j", [_payload(2)])
    with open(os.path.join(d, "trace_9.json"), "w") as f:
        f.write('{"data": [')
    with pytest.raises(native.NativeLoaderError, match="trace_9.json"):
        _load(t_jaeger, d, 2)
    with pytest.raises(json.JSONDecodeError):
        _load(t_jaeger, d, 2, native=False)
    for value in ("auto", "never"):
        with pytest.raises(ValueError, match="native="):
            _load(t_jaeger, d, 2, native=value)


@pytest.mark.parametrize("how", ["compiler", "source"])
def test_failed_build_raises_and_is_not_replaced(tmp_path, monkeypatch, corpus, how):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    if how == "compiler":
        fake = tmp_path / "cxx"
        fake.write_text("#!/bin/sh\necho 'cxx: cannot compile' >&2\nexit 1\n")
        fake.chmod(0o755)
        monkeypatch.setattr(native, "CXX", str(fake))
        match = "cannot compile"
    else:
        src = tmp_path / "loader.cc"
        src.write_text('#include "missing_header.hpp"\n')
        monkeypatch.setattr(native, "SOURCES", (str(src), native.SOURCES[1]))
        match = "missing_header"
    with pytest.raises(native.NativeLoaderError, match=match):
        native.get_lib()
    with pytest.raises(native.NativeLoaderError):
        _load(t_jaeger, corpus[0], 5)
    assert native._LIB is None
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


@gpu
def test_native_ingest_on_card_machine(tmp_path):
    """The loader builds and its store equals the Python front end's on
    the card's machine."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (d,) = synthesize_corpus(str(tmp_path), n_graphs=1, traces_per_graph=300,
                             seed=10)
    nat = _load(t_jaeger, d, 5)
    py = _load(t_jaeger, d, 5, native=False)
    _assert_stores_equal(py, nat)
    assert nat.ingest_front_end == "native" and len(nat.all_processes) == 300
