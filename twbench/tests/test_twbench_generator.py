"""The benchmark's generator against the program's synthesizer, and the
traffic files' trace counts."""

import filecmp
import json
import os

import pytest

from twbench import generator


def _same_tree(a: str, b: str) -> bool:
    cmp = filecmp.dircmp(a, b)
    if cmp.left_only or cmp.right_only or cmp.diff_files or cmp.funny_files:
        return False
    mismatch = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)[1]
    return not mismatch and all(_same_tree(os.path.join(a, d), os.path.join(b, d))
                                for d in cmp.common_dirs)


@pytest.mark.parametrize("seed,graphs,per", [(3, 3, 30), (10, 2, 50)])
def test_one_stream_equals_program_synthesizer(tmp_path, seed, graphs, per):
    from traceweaver_tpu_torch.alibaba.synthesize import replica_counts, synthesize_corpus

    ours = generator.synthesize(str(tmp_path / "a"), [per] * graphs, seed)
    theirs = synthesize_corpus(str(tmp_path / "b"), n_graphs=graphs,
                               traces_per_graph=per, seed=seed)
    assert [os.path.basename(d) for d in ours] == [os.path.basename(d) for d in theirs]
    for a, b in zip(ours, theirs):
        assert _same_tree(a, b)
    services = [f"MS_{i:05d}" for i in range(60)]
    assert generator.replica_counts(services, seed) == replica_counts(services, seed)


def _topologies(dirs):
    """Each graph's call rows, without trace ids and times."""
    out = []
    for d in dirs:
        f = sorted(os.listdir(d))[0]
        with open(os.path.join(d, f)) as fh:
            spans = json.load(fh)["data"][0]["spans"]
        out.append(sorted((s["spanID"], s["caller"], s["callee"], s["processID"])
                          for s in spans))
    return out


def _times(dirs):
    """Each graph's traces as their spans' times and call rows, in time
    order, without trace ids."""
    out = []
    for d in dirs:
        traces = []
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                spans = json.load(fh)["data"][0]["spans"]
            traces.append(sorted((s["startTime"], s["duration"], s["spanID"], s["caller"],
                                  s["callee"], s["processID"]) for s in spans))
        out.append(sorted(traces))
    return out


def test_corpus_seed_fixes_the_work(tmp_path):
    a = generator.synthesize(str(tmp_path / "a"), [40, 20], seed=1, corpus_seed=10)
    b = generator.synthesize(str(tmp_path / "b"), [40, 20], seed=2, corpus_seed=10)
    c = generator.synthesize(str(tmp_path / "c"), [40, 20], seed=1, corpus_seed=11)
    assert _topologies(a) == _topologies(b) != _topologies(c)
    assert _times(a) == _times(b)
    assert [len(os.listdir(d)) for d in a] == [40, 20]
    assert set(os.listdir(a[0])) != set(os.listdir(b[0]))
    # one corpus, relabelled: the program's synthesizer at the corpus seed
    ref = generator.synthesize(str(tmp_path / "r"), [40, 20], seed=10)
    assert _times(a) == _times(ref)


@pytest.mark.parametrize("name,first,last", [
    ("uniform-15x1k", 1000, 1000),
    (dict(graphs=4, distribution="uniform", total_traces=10), 3, 2)])
def test_traffic_counts(name, first, last):
    from twbench import spec

    if isinstance(name, dict):
        traffic = name
    else:
        with open(os.path.join(spec.HERE, "traffic", f"{name}.json")) as f:
            traffic = json.load(f)
    counts = generator.graph_counts(traffic, traffic["graphs"])
    assert sum(counts) == traffic["total_traces"]
    assert counts == sorted(counts, reverse=True)
    assert (counts[0], counts[-1]) == (first, last)


def test_compress_copies_and_shifts():
    from traceweaver_tpu_torch.spans import Span

    def span(tid, sid, start, dur):
        return Span(tid, sid, start, dur, None, [], "p", "server")

    ins = {"in": [span("t1", "a", 4000.0, 100.0), span("t0", "b", 2000.0, 50.0)]}
    outs = {"ep": [span("t0", "c", 2010.0, 20.0), span("t1", "d", 4005.0, 30.0)]}
    cin, cout = generator.compress_problem(ins, outs, 2.0)
    assert [s.start_mus for s in cin["in"]] == [1000.0, 2000.0]
    assert [(s.sid, s.start_mus) for s in cout["ep"]] == [("c", 1010.0), ("d", 2005.0)]
    assert ins["in"][0].start_mus == 4000.0
    assert generator.load_factor("MS_1-loop", 15000, {"MS_1": 100}, {"MS_1-loop": "MS_1"}) == 150
