"""The harness end to end on the CPU at a tiny cut: the program's plain
path equals the frozen reference on every compared number, the control
(the program's bf16 path) and each planted fault come out not correct."""

import contextlib

import pytest

from twbench import faults, harness, spec
from twbench.run import judge
from twbench.tests.conftest import tiny_cell


def _run(mode="sound", workload="exp5-steady", seed=5):
    import torch

    torch.set_num_threads(4)
    cell = tiny_cell(workload)
    plant = faults.planted(mode) if mode in faults.FAULTS else contextlib.nullcontext()
    with plant:
        return cell, harness.run_cell(cell, seed, 0.3, False, device="cpu",
                                      solve_kw=faults.solve_kw(mode),
                                      fit_control=mode == "control")


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_sound_run_equals_reference(seed):
    cell, r = _run(seed=seed)
    checks = dict(r["checks"])
    assert 0.0 < checks.pop("accuracy_pct") <= 100.0
    assert checks == dict(block_gap=0.0, k1_rows_diff=0.0, decode_diff=0.0, fit_gap=0.0,
                          decode_bad=0.0, round_diff=0.0)
    assert r["check_detail"]["k1_gap"] == 0.0
    assert r["check_detail"]["answers"] > 0
    assert r["check_detail"]["launch_rows_unmatched"] == 0
    assert r["check_detail"]["services_unchecked"] == 0
    correct, table = judge(r["checks"], spec.limits(cell.config))
    assert correct, table
    assert r["check_detail"]["k1_launches"] == r["check_detail"]["assembly_launches"] > 0
    assert r["check_detail"]["fit_rows"] > 0
    assert len(r["rounds"]) >= 1 and r["spans_per_s"] > 0
    assert 0.0 < r["accuracy_pct"] <= 100.0
    assert r["builds_in_window"] == 0 and r["failed"] == 0
    assert len(r["counts"]["k1"]) == r["check_detail"]["k1_launches"]


@pytest.mark.parametrize("mode,caught", [("control", "block_gap"), ("control", "fit_gap"),
                                         ("stale", "fit_gap"),
                                         ("half", "k1_rows_diff"),
                                         ("answer", "k1_rows_diff"),
                                         ("decode", "decode_diff")])
def test_control_and_faults_are_not_correct(mode, caught):
    cell, r = _run(mode)
    lim = spec.limits(cell.config)
    correct, table = judge(r["checks"], lim)
    assert not correct, table
    assert r["checks"][caught] > lim[caught]["limit"]


def test_metric_readers_on_a_cpu_run():
    cell, r = _run()
    from twbench.run import read_metrics

    e2e = read_metrics(cell.end_to_end, r)
    assert set(e2e) == {"setup_s", "spans_per_s", "accuracy_pct"}
    layer = read_metrics(cell.per_layer, r)
    # untraced: the readers of the trace find nothing to read
    assert not {"k1_roofline", "assembly_roofline", "round_mfu",
                "device_idle_pct"} & set(layer)
    assert layer["plan_cache_hit_pct"]["value"] == 100.0
    assert all(v["value"] >= 0 for v in layer.values())
