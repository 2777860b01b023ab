"""The deployment's corpus and DAG steps, found by name: exp5's steps give
the deployment the harness built before the steps were files of their own;
a step added as a new file is the one that runs; a configuration or
traffic mix that the harness would not read in full is refused before
set-up writes anything."""

import json
import random
import shutil
import tempfile

import pytest

from twbench import generator, grade, harness, spec
from twbench.tests.conftest import copy_checkout, tiny_cell


def _quiet(msg):
    pass


def _inline_deployment(cell, seed):
    """exp5's deployment as the harness built it with its steps written in
    line: the clean synthesizer and the ground-truth DAG."""
    from traceweaver_tpu_torch.ingest import (
        build_service_problem,
        infer_invocation_dag,
        load_corpus,
    )
    from traceweaver_tpu_torch.metrics import get_ground_truth

    cfg = cell.config
    counts = generator.graph_counts(cell.traffic, int(cfg["n_graphs"]))
    root = tempfile.mkdtemp(prefix="twbench-inline-")
    try:
        dirs = generator.synthesize(root, counts, seed,
                                    corpus_seed=int(cfg["corpus_seed"]),
                                    base_gap_ms=int(cfg["base_gap_ms"]),
                                    n_services=int(cfg["n_services"]))
        random.seed(seed)
        stores = [load_corpus(d, fix=int(cfg["fix"]), max_traces=max(counts) + 1,
                              cache=False) for d in dirs]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    services = [f"MS_{i:05d}" for i in range(int(cfg["n_services"]))]
    replicas = generator.replica_counts(services, int(cfg["corpus_seed"]),
                                        cfg["replica_dist"])
    out = []
    for si, store in enumerate(stores):
        for svc in sorted(store.out_spans_by_process):
            prob = build_service_problem(store, svc, deepcopy=False)
            if prob.skipped:
                continue
            true0 = get_ground_truth(prob.in_span_partitions, prob.out_span_partitions)
            dag = infer_invocation_dag(prob.in_span_partitions, prob.out_span_partitions,
                                       true0, store)
            factor = generator.load_factor(svc, float(cfg["compress"]), replicas,
                                           store.service_loop_map)
            in_parts, out_parts = generator.compress_problem(
                prob.in_span_partitions, prob.out_span_partitions, factor)
            out.append((f"{si}:{svc}", _spans(in_parts), _spans(out_parts), dag.edges(),
                        grade.truth(in_parts, out_parts)))
    return out, sum(len(s.all_spans) for s in stores)


def _spans(parts):
    return {ep: [(s.trace_id, s.sid, s.start_mus, s.duration_mus) for s in spans]
            for ep, spans in parts.items()}


@pytest.mark.parametrize("seed", [3, 11, 2**31 + 29])
def test_exp5_steps_give_the_inline_deployment(seed):
    import torch

    cell = tiny_cell(graphs=3, per=10)
    dep = harness.build_deployment(cell, seed, torch.device("cpu"), _quiet)
    got = [(it.plan_key, _spans(it.in_span_partitions), _spans(it.out_span_partitions),
            it.dag.edges(), tr) for it, tr in zip(dep.items, dep.truth)]
    want, spans = _inline_deployment(cell, seed)
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) > 3
    assert got == want and dep.spans == spans
    assert any(w[3] for w in want)  # some service calls its endpoints in order


def _tiny_checkout(tmp_path, config=None, traffic=None):
    """A copy of the benchmark with a cell ``tiny`` on 3 call graphs of 10
    traces: exp5's configuration updated by ``config`` (a key set to None
    is taken out), a closed-loop traffic mix updated by ``traffic``."""
    root = tmp_path / "checkout"
    b = copy_checkout(root)
    cfg = json.loads((root / "twbench/configs/alibaba-exp5.json").read_text())
    cfg.update(name="tiny-cfg", n_graphs=3)
    mix = dict(name="tiny-3x10", graphs=3, distribution="uniform", total_traces=30,
               loop="closed", rounds_in_flight=1)
    for data, change in ((cfg, config), (mix, traffic)):
        for k, v in (change or {}).items():
            if v is None:
                data.pop(k, None)
            else:
                data[k] = v
    (root / "twbench/configs/tiny-cfg.json").write_text(json.dumps(cfg))
    (root / "twbench/traffic/tiny-3x10.json").write_text(json.dumps(mix))
    b["configs"].append(dict(name="tiny-cfg", source="x",
                             file="twbench/configs/tiny-cfg.json", reduced=[], why="x"))
    b["workloads"].append(dict(name="tiny", config="tiny-cfg", traffic="tiny-3x10",
                               chips=1, why="x"))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def test_new_steps_run_from_new_files(tmp_path):
    """A corpus step and a DAG step written as new files in a copied
    checkout, with a configuration key of the corpus step's own in place
    of one that only exp5's corpus step reads, are the ones that build the
    deployment."""
    import torch

    root = _tiny_checkout(tmp_path, dict(corpus="first_graph", dag="device_only",
                                         first_graphs=1, base_gap_ms=None))
    (root / "twbench/corpora/first_graph.py").write_text(
        "from twbench import generator\n\nKEYS = ('first_graphs',)\n\n\n"
        "def write(root, counts, seed, config):\n"
        "    dirs = generator.synthesize(root, counts, seed, corpus_seed=7)\n"
        "    return dirs[:config['first_graphs']]\n")
    (root / "twbench/dags/device_only.py").write_text(
        "from traceweaver_tpu_torch.dag import DAG\n\n\n"
        "def infer(problem, store, truth, device, config):\n"
        "    return DAG.from_edges([str(device)], [])\n")
    cell = spec.load_cell("tiny", root=str(root))
    dep = harness.build_deployment(cell, 5, torch.device("cpu"), _quiet)
    assert len(dep.stores) == 1 and dep.items
    assert all(list(it.dag) == ["cpu"] and not it.dag.edges() for it in dep.items)


@pytest.mark.parametrize("config,traffic,named", [
    (dict(dag_depth=2), None, "dag_depth"),
    (None, dict(burst=4), "burst"),
    (dict(corpus=None), None, "corpus"),
    (dict(dag=None), None, "dag"),
    (dict(corpus="alibaba_messy"), None, "alibaba_messy"),
    (dict(dag="discovered"), None, "discovered"),
    (dict(corpus="../corpora/alibaba_clean"), None, "corpus"),
    (dict(base_gap_ms=None), None, "base_gap_ms"),
    (dict(fix=None), None, "fix"),
    (None, dict(loop="open"), "loop"),
    (None, dict(rounds_in_flight=2), "rounds_in_flight"),
    (None, dict(distribution="zipf"), "zipf"),
    (None, dict(total_traces=None), "total_traces"),
])
def test_refused_before_set_up(tmp_path, monkeypatch, config, traffic, named):
    import torch

    root = _tiny_checkout(tmp_path, config, traffic)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    with pytest.raises(ValueError, match=named):
        cell = spec.load_cell("tiny", root=str(root))
        harness.build_deployment(cell, 5, torch.device("cpu"), _quiet)
    assert list(scratch.iterdir()) == []
