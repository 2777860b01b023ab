"""exp5's ladder runner (``traceweaver_tpu_torch.runtime.ladder``) on a
tiny synthesized corpus on the CPU: 2 call graphs x 2 rungs. It writes
the JAX executor's five pickle families under the names the plot
scripts read, and the unchanged ``utils/plot_accuracy_vs_*`` scripts
draw both figures from them.
"""

import os
import pickle

import pytest
import torch

from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
from traceweaver_tpu_torch.runtime import ladder
from traceweaver_tpu_torch.runtime.executor import RESULT_FAMILIES

torch.set_num_threads(1)  # small tensors; the test workers share the cores

RUNGS = (1, 15000)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ladder")
    data, out = str(root / "call_graph_data"), str(root / "results")
    synthesize_corpus(data, n_graphs=2, traces_per_graph=48, seed=10)
    calls = []

    def call(argv):
        calls.append(argv)
        ladder._cli_call(argv)

    records = ladder.run_ladder(data, out, rungs=RUNGS, extra=["--device", "cpu"],
                                call=call)
    return data, out, calls, records


def test_runner_calls_every_rung_of_every_graph_in_order(run):
    data, _, calls, records = run
    assert [(r["graph"], r["compress"]) for r in records] == [
        ("call_graph_0", 1), ("call_graph_1", 1),
        ("call_graph_0", 15000), ("call_graph_1", 15000)]
    for argv, r in zip(calls, records):
        a = dict(zip(argv[0::2], argv[1::2]))
        assert a["--absolute_path"] == os.path.join(data, r["graph"])
        assert a["--test_name"] == f"alibaba_cg_{r['graph'][11:]}_load_multiple"
        assert a["--compress_factor"] == str(r["compress"])
        assert (a["--fix"], a["--predictor_indices"], a["--load_level"],
                a["--execute_parallel"]) == ("5", "3,4,7,10", "1", "0")
        assert set(r["accuracy"]) >= {"WAP5", "FCFS", "vPath",
                                      "MaxScoreBatchSubsetWithSkips",
                                      "MaxScoreBatchSubsetWithSkipsTopK"}


def test_pickles_carry_the_names_the_plot_scripts_read(run):
    _, out, _, records = run
    names = set(os.listdir(out))
    for n in (0, 1):
        for compress in RUNGS:
            for kind in RESULT_FAMILIES:
                assert (f"{kind}_alibaba_cg_{n}_load_multiple_1_{compress}_1_0.0.pickle"
                        in names)
    with open(ladder.accuracy_pickle(out, 1, 15000), "rb") as f:
        assert pickle.load(f) == records[3]["accuracy"]
    assert "ladder.json" in names


def test_plot_scripts_draw_both_figures(run):
    _, out, _, _ = run
    for fig in ("fig6a.pdf", "fig6b.pdf"):
        path = os.path.join(out, fig)
        assert os.path.getsize(path) > 1000
        with open(path, "rb") as f:
            assert f.read(5) == b"%PDF-"
    pdfs = ladder.plot(out, messy=True)
    assert [os.path.basename(p) for p in pdfs] == ["fig6a_hard.pdf", "fig6b_hard.pdf"]


class _FirstSolve(Exception):
    pass


def test_messy_ladder_parts_from_jax_only_at_near_tied_plan_masses(tmp_path):
    """The messy corpus's graph 0 at compress 4000: the port's CPU run
    reads 90.27 where JAX reads 90.38. The first place they part is
    window 12 of the flagship's first solve, at its first score block,
    which is well posed. Fed the same block, the port's Sinkhorn and
    rounding and JAX's (``assign_topk_jnp``) assign two rows apart, and
    each such row's two candidate columns carry plan masses equal to
    within a few parts in a million in both plans: the f32 rounding of
    the two logsumexp reductions decides them. The same Sinkhorn in f64
    parts from JAX's f32 assignment on more rows than from the port's,
    so JAX's reading is no exact answer there either."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.ops.pallas_sinkhorn import assign_topk_jnp
    from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as jax_sinkhorn

    import traceweaver_tpu_torch.algorithms.fleet as F
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch.alibaba.synthesize import MESSY_DEFAULT
    from traceweaver_tpu_torch.ops.cuda_sinkhorn import assign_topk_plain, round_topk_plain
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log
    from traceweaver_tpu_torch.runtime import executor as X

    data = str(tmp_path / "messy")
    dirs = synthesize_corpus(data, n_graphs=15, traces_per_graph=1000, seed=10,
                             messy=MESSY_DEFAULT)
    first = {}

    def stop(*args, **kw):
        first.update(args=args, kw=kw)
        raise _FirstSolve

    real_solve = F.solve_windows_fleet
    F.solve_windows_fleet = stop
    try:
        cfg = X.ExecutorConfig(
            data_path=dirs[0], results_directory="", fix=5, cache_rate=0.0,
            load_level=1, compress_factor=4000, repeat_factor=1, execute_parallel=False,
            predictor_indices=[10], max_traces=1000,
            service_to_replica=X.load_replica_table(
                os.path.join(data, "misc", "service_to_replica_new.pickle")),
            device="cpu")
        with pytest.raises(_FirstSolve):
            X.run_experiment(cfg)
    finally:
        F.solve_windows_fleet = real_solve
    n_windows = first["args"][0].shape[0]
    assert n_windows == 13
    window = [t[12:13] if torch.is_tensor(t) and t.dim() and t.shape[0] == n_windows
              else t for t in first["args"]]
    blocks = []

    def keep(*args, **kw):
        blocks.append((args, {k: v for k, v in kw.items() if k != "fused"}))
        return assign_topk(*args, **kw)

    assign_topk = wt.assign_topk
    wt.assign_topk = keep
    try:
        wt.solve_windows_fleet(*window, **first["kw"])
    finally:
        wt.assign_topk = assign_topk
    (S, rm, cm, in_v, cv, cap, W), hyper = blocks[0]
    assert not bool(((rm > 0) & ~((S > -5e8) & (cm > 0)[:, None, :]).any(dim=2)).any())
    port = assign_topk_plain(S, rm, cm, in_v, cv, cap, W, **hyper)[0][0].numpy()
    j = [jnp.asarray(t[0].numpy()) for t in (S, rm, cm, in_v, cv, cap)]
    ref = np.asarray(assign_topk_jnp(*j, W, **hyper)[0])
    sink = dict(epsilon=hyper["epsilon"], n_iters=hyper["n_iters"], tol=hyper["tol"])
    plan_64 = sinkhorn_log(S.double(), rm.double(), cm.double(), **sink).float()[:, :W]
    exact = round_topk_plain(plan_64.contiguous(), in_v, cv, cap, topk=hyper["topk"],
                             min_topk_mass=hyper["min_topk_mass"])[0][0].numpy()
    rows = np.nonzero(port != ref)[0]
    assert 0 < len(rows) <= 4, rows
    p_port = sinkhorn_log(S, rm, cm, **sink)[0, :W].numpy()
    p_jax = np.asarray(jax_sinkhorn(j[0], j[1], j[2], **sink))[:W]
    for i in rows:
        a, b = int(port[i]), int(ref[i])
        for plan in (p_port, p_jax):
            assert abs(plan[i, a] - plan[i, b]) <= 5e-6 * max(plan[i, a], plan[i, b]), (
                i, plan[i, a], plan[i, b])
    assert int((ref != exact).sum()) > int((port != exact).sum()) > 0
