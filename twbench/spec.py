"""What ``BENCHMARK.json`` names, found by name in files of their own.

- a cell is an entry of ``workloads``; its configuration is the file its
  ``configs`` entry names, its traffic mix ``twbench/traffic/<traffic>.json``;
- a configuration's ``corpus`` names ``twbench/corpora/<corpus>.py``, whose
  ``write(root, counts, seed, config)`` writes the corpus of a run under
  ``root`` (``counts``: traces a call graph) and returns the directories
  the program's ``load_corpus`` reads;
- its ``dag`` names ``twbench/dags/<dag>.py``, whose
  ``infer(problem, store, truth, device, config)`` returns one service's
  invocation DAG from its problem before the load transform, its store,
  its ground truth and the run's device;
- a corpus or DAG step may list in ``KEYS`` the configuration keys it
  reads besides :data:`CONFIG_READ`; each must be in the configuration;
- a metric is an entry of ``end_to_end`` or ``per_layer``; a per-layer
  metric is read by ``twbench/metrics/<name>.py``, whose ``read(reading)``
  returns a number or None (nothing to read: the metric is left out).

A new cell, configuration, corpus or DAG step, traffic mix or metric is
therefore new files and new entries, and no edit of a file here.

:func:`load_cell` refuses, before set-up writes anything, a configuration
or traffic key that is neither read (:data:`CONFIG_READ`, a step's
``KEYS``, :data:`TRAFFIC_READ`) nor documentation (:data:`CONFIG_DOC`,
:data:`TRAFFIC_DOC`), a read key that is missing, a step with no file, and
a traffic value the harness does not implement (:data:`TRAFFIC_VALUES`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional

from twbench import generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "twbench")

#: configuration keys the harness reads, and where
CONFIG_READ = {
    "corpus": "the corpus step: twbench/corpora/<corpus>.py",
    "dag": "the invocation-DAG step: twbench/dags/<dag>.py",
    "n_graphs": "generator.graph_counts: call graphs, the traffic's graphs",
    "n_services": "harness.build_deployment: the services of the replica table",
    "corpus_seed": "harness.build_deployment: the replica table's seed",
    "replica_dist": "harness.build_deployment: the replica table",
    "compress": "harness.build_deployment: exp5's load transform",
    "fix": "harness.build_deployment: load_corpus's fix mode",
    "method": "harness.build_deployment: each service's solver",
    "solve": "harness.run_cell: solve_fleet's arguments, refused by it",
    "limits": "limits: the configuration's own limits",
}
#: read keys a configuration may leave out (``solve_fleet``'s defaults, the
#: default limits alone)
CONFIG_OPTIONAL = ("solve", "limits")
#: configuration keys that document the deployment; nothing reads them
#: (``traces_per_graph``: the traffic mix gives the counts)
CONFIG_DOC = ("name", "source", "deployment", "guarantees", "assumed", "reduced",
              "why", "traces_per_graph")
#: traffic keys that ``generator.graph_counts`` reads, each required
TRAFFIC_COUNTS = ("graphs", "distribution", "total_traces")
#: traffic keys the harness reads; ``loop`` and ``rounds_in_flight`` only
#: say what every run does
TRAFFIC_READ = TRAFFIC_COUNTS + ("loop", "rounds_in_flight")
#: traffic keys that document the mix
TRAFFIC_DOC = ("name", "why")
#: the traffic values the harness implements: whole fleet rounds back to
#: back, one in flight (``distribution``: ``generator.graph_counts``'s)
TRAFFIC_VALUES = {"loop": ("closed",), "rounds_in_flight": (1,)}

#: a step's name: a file name under its folder, no path
STEP_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_-]{0,63}$")


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    corpus: Callable
    dag: Callable
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(folder: str, name: str, root: str) -> ModuleType:
    """``twbench/<folder>/<name>.py`` of the checkout at ``root``."""
    path = os.path.join(root, "twbench", folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no such file")
    spec = importlib.util.spec_from_file_location(f"twbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: str = ROOT) -> Dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no benchmark definition")
    return _load_json(path)


def _step(config: Dict, key: str, folder: str, path: str, root: str) -> ModuleType:
    name = config.get(key)
    if not isinstance(name, str) or not STEP_NAME.match(name):
        raise ValueError(f"{path}: {key!r} must name a file of twbench/{folder}/, "
                         f"not {name!r}")
    try:
        return _module(folder, name, root)
    except FileNotFoundError as e:
        raise ValueError(f"{path}: {key!r} names {name!r}, which has no file ({e})") from None


def _check_keys(data: Dict, read, doc, path: str, kind: str) -> None:
    for key in data:
        if key not in read and key not in doc:
            raise ValueError(f"{path}: {kind} key {key!r} is neither read by the harness "
                             f"nor documentation")


def _check_config(config: Dict, path: str, root: str):
    """The configuration's corpus and DAG steps, once every key of it is
    read or documentation and every read key is there."""
    corpus = _step(config, "corpus", "corpora", path, root)
    dag = _step(config, "dag", "dags", path, root)
    read = set(CONFIG_READ) | set(getattr(corpus, "KEYS", ())) | set(getattr(dag, "KEYS", ()))
    _check_keys(config, read, CONFIG_DOC, path, "configuration")
    for key in sorted(read - set(CONFIG_OPTIONAL)):
        if key not in config:
            raise ValueError(f"{path}: configuration key {key!r} is read and missing")
    return corpus, dag


def _check_traffic(traffic: Dict, n_graphs: int, path: str) -> None:
    """Every key of the traffic mix read or documentation, its values
    ones the harness implements, its counts drawn for ``n_graphs``."""
    _check_keys(traffic, TRAFFIC_READ, TRAFFIC_DOC, path, "traffic")
    for key, allowed in TRAFFIC_VALUES.items():
        if key in traffic and traffic[key] not in allowed:
            raise ValueError(f"{path}: traffic {key!r} is {traffic[key]!r}; the harness "
                             f"implements {list(allowed)}")
    for key in TRAFFIC_COUNTS:
        if key not in traffic:
            raise ValueError(f"{path}: traffic key {key!r} is read and missing")
    try:
        generator.graph_counts(traffic, n_graphs)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, with its
    configuration, its traffic, its corpus and DAG steps and the metrics
    it reports; refused as the module docstring says."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_path = os.path.join(root, configs[w["config"]]["file"])
    config = _load_json(config_path)
    corpus, dag = _check_config(config, config_path, root)
    traffic_path = os.path.join(root, "twbench", "traffic", f"{w['traffic']}.json")
    traffic = _load_json(traffic_path)
    _check_traffic(traffic, int(config["n_graphs"]), traffic_path)
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                corpus=corpus.write, dag=dag.infer,
                end_to_end=list(bench["end_to_end"]), per_layer=list(bench["per_layer"]))


def reader(name: str, root: str = ROOT) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``twbench/metrics/<name>.py``."""
    try:
        return _module("metrics", name, root).read
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{e}: no reader for metric {name!r}") from None


def limits(config: Dict, root: str = ROOT) -> Dict[str, Dict]:
    """The limit of each compared number: ``twbench/limits/default.json``,
    then the configuration's own ``limits`` (its accuracy floor). Each is
    ``{"limit": x}``, a number at most ``x``, or ``{"at_least": x}``."""
    path = os.path.join(root, "twbench", "limits", "default.json")
    table = dict(_load_json(path)["numbers"])
    table.update(config.get("limits", {}))
    return {k: ({"at_least": float(v["at_least"])} if "at_least" in v
                else {"limit": float(v["limit"])}) for k, v in table.items()}
