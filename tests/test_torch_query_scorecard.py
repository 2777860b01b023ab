"""The port's ``query`` and ``scorecard`` against the JAX package's (CPU).

- ``delay_culprit`` and ``filter_traces`` over an ``e2e_*`` pickle the
  port's executor wrote equal JAX's over the same pickle, and the
  ``query`` subcommand prints JAX's lines;
- ``overlap_fraction``, ``service_regime``,
  ``accuracy_by_confidence_decile`` and ``calibration_monotone`` equal
  JAX's on the same spans and seeded confidences;
- ``run_scorecard(seed=0, n_traces=32)`` on the CPU equals JAX's
  per-regime table within 0.5 pt (JAX's solver leg ``weaver_tpu`` is
  the port's ``weaver_torch``) with the same calibration verdict.
"""

import glob
import importlib
import pickle

import numpy as np
import pytest
import torch

import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
from traceweaver_tpu_torch.metrics import accuracy as t_acc

# the packages export the function under the module's name
t_query = importlib.import_module("traceweaver_tpu_torch.query.delay_culprit")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def e2e_pickle(tmp_path_factory):
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.runtime import cli

    root = tmp_path_factory.mktemp("q")
    (d,) = synthesize_corpus(str(root / "c"), n_graphs=1, traces_per_graph=120,
                             seed=10)
    out = root / "out"
    assert cli.main(["--absolute_path", d, "--fix", "5", "--cache_rate", "0",
                     "--compress_factor", "15000", "--execute_parallel", "0",
                     "--predictor_indices", "3,4,10", "--results_directory",
                     str(out), "--device", "cpu"]) == 0
    (path,) = glob.glob(str(out / "e2e_*.pickle"))
    return path


@pytest.mark.parametrize("percentile,after", [(0.95, None), (0.5, None),
                                               (0.8, 1.0), (1.0, None)])
def test_delay_culprit_equals_jax(e2e_pickle, tmp_path, percentile, after):
    j_query = importlib.import_module("traceweaver_tpu.query.delay_culprit")

    with open(e2e_pickle, "rb") as f:
        traces = pickle.load(f)
    assert set(traces) == {"WAP5", "FCFS", "MaxScoreBatchSubsetWithSkips"}
    if after is not None:  # after the median root start
        starts = sorted(t[0].start_mus for t in traces["FCFS"][0].values() if t)
        after = starts[len(starts) // 2]
    for true_traces, _ in traces.values():
        assert t_query.filter_traces(true_traces, percentile, after) == \
            j_query.filter_traces(true_traces, percentile, after)
    got = t_query.delay_culprit(e2e_pickle, percentile, after,
                                out_path=str(tmp_path / "t.pickle"))
    want = j_query.delay_culprit(e2e_pickle, percentile, after,
                                 out_path=str(tmp_path / "j.pickle"))
    assert got == want
    assert (tmp_path / "t.pickle").read_bytes() == (tmp_path / "j.pickle").read_bytes()
    assert any(not r["empty"] for r in got.values()) or percentile == 1.0


def test_query_subcommand_prints_jax_lines(e2e_pickle, capsys):
    from traceweaver_tpu_torch.runtime import cli

    j_query = importlib.import_module("traceweaver_tpu.query.delay_culprit")

    assert j_query.main([e2e_pickle, "--percentile", "0.9"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["query", e2e_pickle, "--percentile", "0.9"]) == 0
    assert capsys.readouterr().out == want
    assert "worst hop (true)" in want


def test_regime_features_equal_jax():
    from traceweaver_tpu.metrics import accuracy as j_acc
    from traceweaver_tpu.metrics.scorecard import synth_labeled_corpus as j_corpus

    from traceweaver_tpu_torch.metrics.synth import synth_labeled_corpus as t_corpus

    for seed, n in ((0, 48), (3, 7), (5, 1)):
        for jp, tp in zip(j_corpus(seed, n), t_corpus(seed, n)):
            j_in = next(iter(jp["in_parts"].values()))
            t_in = next(iter(tp["in_parts"].values()))
            assert t_acc.overlap_fraction(t_in) == j_acc.overlap_fraction(j_in)
            for kw in ({}, dict(fanout_degree=2, overlap_frac=0.9)):
                assert t_acc.service_regime(tp["in_parts"], tp["out_parts"], **kw) == \
                    j_acc.service_regime(jp["in_parts"], jp["out_parts"], **kw)
    assert t_acc.overlap_fraction([]) == 0.0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("nbins", [10, 3, 40])
def test_calibration_functions_equal_jax(seed, nbins):
    from traceweaver_tpu.metrics import accuracy as j_acc

    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 200))
    conf = {("t", f"s{i}"): float(rng.choice([0.25, 0.5, 1.0, rng.random()]))
            for i in range(n)}
    # seed 0 is calibrated, the others are inverted in part
    correct = {k: bool(rng.random() < (v if seed == 0 else 1.0 - v))
               for k, v in conf.items()}
    table = t_acc.accuracy_by_confidence_decile(conf, correct, nbins)
    assert table == j_acc.accuracy_by_confidence_decile(conf, correct, nbins)
    for tol in (0.05, 0.0):
        assert t_acc.calibration_monotone(table, tol) == \
            j_acc.calibration_monotone(table, tol)


def test_scorecard_equals_jax(capsys):
    from traceweaver_tpu.metrics.scorecard import run_scorecard as j_run

    from traceweaver_tpu_torch.metrics.scorecard import SOLVER_METHOD, run_scorecard
    from traceweaver_tpu_torch.runtime import cli

    j_card = j_run(seed=0, n_traces=32)
    t_card = run_scorecard(seed=0, n_traces=32, device="cpu")
    assert set(t_card["per_regime"]) == set(j_card["per_regime"]) == {
        "async", "fanout", "sequential"}
    for regime, accs in j_card["per_regime"].items():
        mine = dict(t_card["per_regime"][regime])
        mine["weaver_tpu"] = mine.pop(SOLVER_METHOD)
        assert set(mine) == set(accs)
        for m, a in accs.items():
            assert abs(mine[m] - a) <= 0.005, (regime, m)
    assert t_card["calibration_monotone_ok"] == j_card["calibration_monotone_ok"]
    assert len(t_card["calibration"]) == len(j_card["calibration"]) == 10
    assert cli.main(["scorecard", "--traces", "16", "--device", "cpu"]) == 0
    assert "calibration monotone-ish:" in capsys.readouterr().out


def test_scorecard_without_card_raises(monkeypatch):
    from traceweaver_tpu_torch.metrics.scorecard import run_scorecard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scorecard(n_traces=8)
