"""Shared pieces of the benchmark's tests: a tiny cut of a cell for the
CPU (two call graphs of a few tens of traces), and a copy of the
benchmark that a test may add files to."""

import json
import shutil

import pytest

from twbench import spec


def tiny_cell(workload: str = "exp5-steady", graphs: int = 2, per: int = 60):
    cell = spec.load_cell(workload)
    cell.config["n_graphs"] = graphs
    cell.traffic.update(graphs=graphs, total_traces=graphs * per)
    return cell


def copy_checkout(root):
    """``twbench/`` and ``BENCHMARK.json`` copied under ``root``
    (a ``pathlib.Path``); returns the benchmark's definition."""
    shutil.copytree(spec.HERE, root / "twbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
