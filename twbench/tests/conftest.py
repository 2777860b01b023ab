"""Shared pieces of the benchmark's tests: a tiny cut of a cell for the
CPU (two call graphs of a few tens of traces)."""

import pytest

from twbench import spec


def tiny_cell(workload: str = "exp5-steady", graphs: int = 2, per: int = 60):
    cell = spec.load_cell(workload)
    cell.config["n_graphs"] = graphs
    cell.traffic.update(graphs=graphs, total_traces=graphs * per)
    return cell


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
