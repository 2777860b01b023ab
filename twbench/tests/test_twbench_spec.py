"""BENCHMARK.json against the contract's forms, and a cell, a traffic mix
and a metric added by new files alone."""

import json
import os
import re

import pytest

from twbench import spec
from twbench.tests.conftest import copy_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    return spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_names_units_and_entries():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("twbench/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    names = [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(names)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert _line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert os.path.exists(os.path.join(spec.HERE, "metrics", f"{m['name']}.py"))


def test_every_cell_loads():
    for w in _bench()["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["graphs"] == cell.config["n_graphs"]
        assert cell.corpus is not None and cell.dag is not None
        lim = spec.limits(cell.config)
        assert "at_least" in lim["accuracy_pct"] and "limit" in lim["decode_diff"]


def test_new_cell_traffic_and_metric_by_new_files(tmp_path):
    """A copy of the benchmark gains a configuration with its own corpus
    and DAG steps, a traffic mix, a cell and a per-layer metric by new
    files and new entries alone."""
    root = tmp_path / "checkout"
    b = copy_checkout(root)
    cfg = json.loads((root / "twbench/configs/alibaba-exp5.json").read_text())
    cfg.update(name="alibaba-exp5-x", n_graphs=3, corpus="clean_x", dag="flat_x",
               corpus_x=1)
    del cfg["base_gap_ms"]  # read by exp5's corpus step alone
    (root / "twbench/configs/alibaba-exp5-x.json").write_text(json.dumps(cfg))
    (root / "twbench/corpora/clean_x.py").write_text(
        "KEYS = ('corpus_x',)\n\n\ndef write(root, counts, seed, config):\n"
        "    return []\n")
    (root / "twbench/dags/flat_x.py").write_text(
        "def infer(problem, store, truth, device, config):\n    return None\n")
    (root / "twbench/traffic/tiny-3x10.json").write_text(json.dumps(
        dict(name="tiny-3x10", graphs=3, distribution="uniform",
             total_traces=30, loop="closed", rounds_in_flight=1)))
    (root / "twbench/metrics/rounds_run.py").write_text(
        "def read(reading):\n    return float(len(reading['rounds']))\n")
    b["configs"].append(dict(name="alibaba-exp5-x", source="x", file=
                             "twbench/configs/alibaba-exp5-x.json", reduced=[], why="x"))
    b["workloads"].append(dict(name="tiny", config="alibaba-exp5-x", traffic="tiny-3x10",
                               chips=1, why="x"))
    b["per_layer"].append(dict(name="rounds_run", unit="rounds", better="higher",
                               source="host_clock", layer="harness round",
                               moves="spans_per_s"))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("tiny", root=str(root))
    assert cell.config["n_graphs"] == 3 and cell.traffic["total_traces"] == 30
    assert cell.corpus.__code__.co_filename == str(root / "twbench/corpora/clean_x.py")
    assert cell.dag.__code__.co_filename == str(root / "twbench/dags/flat_x.py")
    assert "rounds_run" in [m["name"] for m in cell.per_layer]
    assert spec.reader("rounds_run", root=str(root))({"rounds": [1, 2]}) == 2.0
    assert spec.limits(cell.config, root=str(root)) == spec.limits(
        spec.load_cell("exp5-steady").config)


def test_missing_benchmark_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        spec.load_benchmark(str(tmp_path))
