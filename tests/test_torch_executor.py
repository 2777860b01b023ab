"""The port's batch executor and CLI vs the JAX package's (CPU), and on
the card.

JAX ``run_experiment`` against the port's (``device="cpu"``) on a
2-graph x 256-trace synthesized Alibaba corpus at compress 15000 with
predictors 3-10 (``execute_parallel`` off in both):

- slots 3-7 (host baselines): per-process and end-to-end accuracies and
  every assignment equal exactly;
- slots 8-10 (``WeaverTorch``, slot 10 through ``solve_fleet``):
  per-process accuracy within 0.5 pt, end-to-end within 0.5 pt, and at
  least 99% equal assignments (XLA and PyTorch may break near ties of a
  plan differently, ``ops/compare.py``);
- the same five result-pickle files with the same keys, and equal
  contents for slots 3-7, field by field;
- ``execute_parallel`` on and off give equal results;
- slot 10 takes the fleet route, and ``--parallel`` takes it off;
- the CLI in a subprocess with ``--device cpu`` writes the five
  families; with no card and no ``--device`` it exits non-zero.

The ``gpu`` tests run the executor on the card against the CPU (run with
``--noconftest``: this module imports JAX only inside the CPU tests).
"""

import os
import pickle
import subprocess
import sys

import pytest
import torch

from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
from traceweaver_tpu_torch.runtime import executor as tx

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRAPHS, N_TRACES = 2, 256
SLOTS = list(range(3, 11))
HOST_KEYS = ("WAP5", "FCFS", "ArrivalOrder", "vPathOld", "vPath")
DEVICE_KEYS = ("MaxScoreBatchParallelWithoutIterations", "MaxScoreBatchParallel",
               "MaxScoreBatchSubsetWithSkips")
gpu = pytest.mark.gpu


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp5")
    dirs = synthesize_corpus(str(root), n_graphs=N_GRAPHS,
                             traces_per_graph=N_TRACES, seed=10)
    table = tx.load_replica_table(os.path.join(root, "misc",
                                               "service_to_replica_new.pickle"))
    return root, dirs, table


def _config(mod, graph_dir, table, results, **kw):
    base = dict(data_path=graph_dir, results_directory=results, fix=5,
                cache_rate=0.0, load_level=1, test_name="alibaba_cg",
                compress_factor=15000, execute_parallel=False,
                predictor_indices=SLOTS, service_to_replica=table)
    base.update(kw)
    return mod.ExecutorConfig(**base)


def _run(mod, cfg, monkeypatch):
    """``run_experiment`` with every per-service record kept: returns the
    results and ``{(method key, process): prediction}``."""
    records = []
    real = mod._finish_service

    def keep(prep, process, out, elapsed):
        r = real(prep, process, out, elapsed)
        records.append((process, r["pred"]))
        return r

    monkeypatch.setattr(mod, "_finish_service", keep)
    res = mod.run_experiment(cfg)
    monkeypatch.undo()
    keys = [k for k in res.accuracy_overall if not k.endswith("TopK")]
    n = len(records) // len(keys)
    assert n * len(keys) == len(records)
    preds = {(keys[i // n], p): pred for i, (p, pred) in enumerate(records)}
    return res, preds


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    import traceweaver_tpu.runtime.executor as jx

    _, dirs, table = corpus
    mp = pytest.MonkeyPatch()
    out = []
    for n, d in enumerate(dirs):
        res_dir = tmp_path_factory.mktemp(f"results{n}")
        j = _run(jx, _config(jx, d, table, str(res_dir / "jax")), mp)
        t = _run(tx, _config(tx, d, table, str(res_dir / "torch"), device="cpu"), mp)
        out.append((d, res_dir, j, t))
    return out


def _pairs(a, b):
    """Share of ``a``'s (endpoint, span) pairs that ``b`` assigns alike."""
    pairs = [(ep, i) for ep in a for i in a[ep]]
    return sum(a[ep][i] == b[ep].get(i) for ep, i in pairs) / len(pairs)


@pytest.mark.parametrize("graph", range(N_GRAPHS))
def test_host_slots_equal_exactly(runs, graph):
    _, _, (jr, jp), (tr, tp) = runs[graph]
    for key in HOST_KEYS:
        assert jr.accuracy_overall[key] == tr.accuracy_overall[key]
        procs = [p for k, p in jp if k == key]
        assert procs == [p for k, p in tp if k == key]
        for p in procs:
            assert jr.accuracy_per_process[(key, p)] == tr.accuracy_per_process[(key, p)]
            assert jp[(key, p)] == tp[(key, p)]
        assert jr.accuracy_percentile_bins[key] == tr.accuracy_percentile_bins[key]


@pytest.mark.parametrize("graph", range(N_GRAPHS))
def test_device_slots_within_half_a_point(runs, graph):
    _, _, (jr, jp), (tr, tp) = runs[graph]
    assert set(jr.accuracy_overall) == set(tr.accuracy_overall)
    for key in DEVICE_KEYS:
        assert abs(jr.accuracy_overall[key] - tr.accuracy_overall[key]) <= 0.5
        for (k, p), pred in jp.items():
            if k != key:
                continue
            assert abs(jr.accuracy_per_process[(k, p)]
                       - tr.accuracy_per_process[(k, p)]) <= 0.005
            assert _pairs(pred, tp[(k, p)]) >= 0.99, (key, p)
    # not vacuous: the flagship beats the worst host baseline
    flag = tr.accuracy_overall["MaxScoreBatchSubsetWithSkips"]
    assert flag > min(tr.accuracy_overall[k] for k in HOST_KEYS) + 10


def _span_fields(s):
    return None if s is None else (s.trace_id, s.sid, s.start_mus, s.duration_mus,
                                   s.op_name, list(s.references), s.process_id,
                                   s.span_kind)


@pytest.mark.parametrize("graph", range(N_GRAPHS))
def test_result_pickles_match(runs, graph):
    _, res_dir, _, _ = runs[graph]
    names = sorted(os.listdir(res_dir / "jax"))
    assert names == sorted(os.listdir(res_dir / "torch"))
    assert sorted(f"{k}_alibaba_cg_1_15000_1_0.0.pickle"
                  for k in tx.RESULT_FAMILIES) == names
    for name in names:
        with open(res_dir / "jax" / name, "rb") as f:
            j = pickle.load(f)
        with open(res_dir / "torch" / name, "rb") as f:
            t = pickle.load(f)
        assert list(j) == list(t), name
        if name.startswith("e2e"):
            for key in j:
                (jt, jp), (tt, tp) = j[key], t[key]
                assert list(jt) == list(tt) and list(jp) == list(tp)
                assert all([_span_fields(s) for s in jt[i]] ==
                           [_span_fields(s) for s in tt[i]] for i in jt)
                if key in HOST_KEYS:
                    assert all([_span_fields(s) for s in jp[i]] ==
                               [_span_fields(s) for s in tp[i]] for i in jp)
        elif name.startswith(("bin_acc", "accuracy", "process_acc")):
            for key in j:
                method = key[0] if isinstance(key, tuple) else key
                if method in HOST_KEYS:
                    assert j[key] == t[key], (name, key)


def test_execute_parallel_gives_equal_results(corpus, runs, tmp_path, monkeypatch):
    _, dirs, table = corpus
    _, _, _, (tr, tp) = runs[0]
    cfg = _config(tx, dirs[0], table, "", device="cpu", execute_parallel=True,
                  predictor_indices=SLOTS[:-1])
    res, preds = _run(tx, cfg, monkeypatch)
    assert res.accuracy_per_process == {k: v for k, v in tr.accuracy_per_process.items()
                                        if k[0] != "MaxScoreBatchSubsetWithSkips"}
    assert all(preds[k] == tp[k] for k in preds)
    assert not res.fleet_stats


def test_flagship_takes_the_fleet_route(corpus, runs, monkeypatch):
    _, _, _, (tr, _) = runs[0]
    fleet = tr.fleet_stats["MaxScoreBatchSubsetWithSkips"]
    assert fleet["fleet_dispatches"] >= 1 and fleet["fleet_services"] >= 3
    assert "prepare_s" in fleet and tr.seconds["ingest"] > 0
    # --parallel: single-iteration sibling scoring, which the fleet does
    # not carry, so the flagship goes service by service
    _, dirs, table = corpus
    res, _ = _run(tx, _config(tx, dirs[0], table, "", device="cpu", parallel=True,
                              predictor_indices=[10]), monkeypatch)
    assert not res.fleet_stats


def _cli(args, **kw):
    return subprocess.run([sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": REPO}, **kw)


def test_cli_writes_the_five_families(corpus, tmp_path):
    _, dirs, _ = corpus
    out = _cli(["--absolute_path", dirs[1], "--fix", "5", "--cache_rate", "0",
                "--compress_factor", "15000", "--test_name", "cg1",
                "--results_directory", str(tmp_path), "--predictor_indices", "4,10",
                "--execute_parallel", "0", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert "End-to-end accuracy for method MaxScoreBatchSubsetWithSkips" in out.stdout
    assert "[fleet] MaxScoreBatchSubsetWithSkips:" in out.stdout
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{k}_cg1_0_15000_1_0.0.pickle" for k in tx.RESULT_FAMILIES)


def test_cli_without_card_or_device_exits_nonzero(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, dirs, _ = corpus
    out = _cli(["--absolute_path", dirs[0], "--fix", "5", "--cache_rate", "0",
                "--results_directory", str(tmp_path)])
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tx.run_experiment(tx.ExecutorConfig(data_path=dirs[0], results_directory="",
                                            fix=5))


def test_weaver_torch_calls_do_not_share_state(monkeypatch):
    """The thread pool calls one ``WeaverTorch`` from several threads. A
    call that starts while another is between its dispatch and its
    pass-count check must not change the other's result: each call
    keeps its stage ledger and ``fused_em_applied`` to itself (they
    were attributes of the instance, reset by every call)."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.metrics.synth import synth_async_8k

    def solve(algo, prob, method="MaxScoreBatchSubsetWithSkips"):
        return algo.FindAssignments(
            method, prob["service"], prob["in_parts"], prob["out_parts"],
            False, [], prob["truth"], prob["dag"])

    first, other = synth_async_8k(96, seed=1), synth_async_8k(64, seed=2)
    algo = WeaverTorch({}, {}, device="cpu")
    alone = solve(algo, first)
    assert algo.stats.get("fused_em_applied") == 1.0
    real, calls = algo._solve_once, []

    def interleaved(*args, **kw):
        out = real(*args, **kw)
        if not calls:  # the other call runs to its end in between
            calls.append("other")
            solve(algo, other, "MaxScoreBatchParallelWithoutIterations")
            assert not algo.stats.get("fused_em_applied")  # one pass
        return out

    monkeypatch.setattr(algo, "_solve_once", interleaved)
    assert solve(algo, first) == alone
    # one fused two-pass dispatch, no host refit pass after it
    assert calls and algo.stats.get("fused_em_applied") == 1.0
    assert "refit_s" not in algo.stats


def _whole_ms_rows(seed, rows=8, n=1000):
    """Refit rows like the flagship's on the exp5 corpus: whole
    milliseconds around 1-3 centres, 1% of samples off by 1-3.5e6 us,
    500-1000 samples a row. Returns samples, mask and priors (K = 5)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.zeros((rows, n), np.float32)
    m = np.zeros((rows, n), bool)
    for i in range(rows):
        k = int(rng.integers(1, 4))
        v = (rng.integers(2, 130, size=k)[rng.integers(0, k, size=n)]
             + rng.integers(-6, 7, size=n)) * 1000
        far = rng.random(n) < 0.01
        v = np.where(far, rng.choice([-1, 1], size=n)
                     * rng.integers(1000, 3500, size=n) * 1000, v)
        cnt = int(rng.integers(n // 2, n + 1))
        x[i, :cnt], m[i, :cnt] = v[:cnt], True
    prior = np.random.default_rng(seed + 100).random((3, rows, 5)).astype(np.float32)
    return torch.as_tensor(x), torch.as_tensor(m), [torch.as_tensor(p) for p in prior]


def _same_fit(a, b):
    """Same component count per row; every parameter within 1e-3 of
    ``|b| + 1`` (the GMM tolerance of ``tests/test_torch_ops.py``)."""
    assert torch.equal(a[0] > 0, b[0] > 0)
    for p, q in zip(a, b):
        assert float(((p - q).abs() / (q.abs() + 1.0)).max()) < 1e-3


@pytest.mark.parametrize("seed", [0, 6, 14])
def test_refit_ignores_sample_order(seed):
    """The device EM refit on whole-millisecond delays does not follow
    the order of its f32 sums: the samples in reverse order give the
    same mixtures. (On the exp5 corpus the card's flagship parts from
    the CPU's through pass 0's ill-posed windows, not the refit.)"""
    from traceweaver_tpu_torch.ops.gmm import fit_gmm_in_graph

    x, m, prior = _whole_ms_rows(seed)
    _same_fit(fit_gmm_in_graph(x.flip(1), m.flip(1), *prior),
              fit_gmm_in_graph(x, m, *prior))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@gpu
@pytest.mark.parametrize("seed", [0, 6, 14])
def test_refit_on_card_matches_cpu(seed):
    """The same refit rows on the card and on the CPU give the same
    mixtures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traceweaver_tpu_torch.ops.gmm import fit_gmm_in_graph

    x, m, prior = _whole_ms_rows(seed)
    card = fit_gmm_in_graph(x.cuda(), m.cuda(), *(p.cuda() for p in prior))
    _same_fit([a.cpu() for a in card], fit_gmm_in_graph(x, m, *prior))


@gpu
def test_executor_on_card_matches_cpu(corpus, tmp_path):
    """Slots 4, 8, 9 and 10 of one graph on the card and on the CPU: the
    host slot equal, the device slots within half a point end to end,
    and slot 10 through the fleet with the fused kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    _, dirs, table = corpus
    got = {}
    for device in ("cuda", "cpu"):
        K.reset_launches()
        cfg = _config(tx, dirs[0], table, str(tmp_path / device), device=device,
                      predictor_indices=[4, 8, 9, 10])
        got[device] = (tx.run_experiment(cfg), dict(K.LAUNCHES))
    (card, launches), (cpu, _) = got["cuda"], got["cpu"]
    assert launches["fused_assign"] > 0 and launches["sinkhorn"] == 0
    assert card.accuracy_overall["FCFS"] == cpu.accuracy_overall["FCFS"]
    for key in DEVICE_KEYS:
        assert abs(card.accuracy_overall[key] - cpu.accuracy_overall[key]) <= 0.5
    assert card.fleet_stats["MaxScoreBatchSubsetWithSkips"]["fleet_dispatches"] >= 1
    assert sorted(os.listdir(tmp_path / "cuda")) == sorted(os.listdir(tmp_path / "cpu"))


@gpu
def test_execute_parallel_on_card(corpus):
    """The thread pool calls one ``WeaverTorch`` from several threads on
    the card: results equal the serial run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, dirs, table = corpus
    res = [tx.run_experiment(_config(tx, dirs[1], table, "", device="cuda",
                                     execute_parallel=pool, predictor_indices=[8, 9]))
           for pool in (False, True)]
    assert res[0].accuracy_per_process == res[1].accuracy_per_process
    assert res[0].accuracy_overall == res[1].accuracy_overall
