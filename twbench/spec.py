"""What ``BENCHMARK.json`` names, found by name in files of their own.

- a cell is an entry of ``workloads``; its configuration is the file its
  ``configs`` entry names, its traffic mix ``twbench/traffic/<traffic>.json``;
- a metric is an entry of ``end_to_end`` or ``per_layer``; a per-layer
  metric is read by ``twbench/metrics/<name>.py``, whose ``read(reading)``
  returns a number or None (nothing to read: the metric is left out).

A new cell, configuration, traffic mix or metric is therefore new files
and new entries, and no edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "twbench")


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no benchmark definition")
    return _load_json(path)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, with its
    configuration, its traffic and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "twbench", "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=list(bench["end_to_end"]), per_layer=list(bench["per_layer"]))


def reader(name: str, root: str = ROOT) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``twbench/metrics/<name>.py``."""
    path = os.path.join(root, "twbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"twbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"{path}: no reader for metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def limits(config: Dict, root: str = ROOT) -> Dict[str, Dict]:
    """The limit of each compared number: ``twbench/limits/default.json``,
    then the configuration's own ``limits`` (its accuracy floor). Each is
    ``{"limit": x}``, a number at most ``x``, or ``{"at_least": x}``."""
    path = os.path.join(root, "twbench", "limits", "default.json")
    table = dict(_load_json(path)["numbers"])
    table.update(config.get("limits", {}))
    return {k: ({"at_least": float(v["at_least"])} if "at_least" in v
                else {"limit": float(v["limit"])}) for k, v in table.items()}
