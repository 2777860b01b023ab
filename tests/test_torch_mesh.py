"""The port's multi-device tier against the JAX package's on the CPU.

JAX runs on its eight virtual CPU devices (``tests/conftest.py``); the
port's counterpart is a mesh naming the CPU eight times. On the same
numpy inputs:

- ``shard_solve_windows`` (``__graft_entry__._example_arrays``, B = 16
  and a ragged B = 13): all four outputs equal JAX's and the port's
  unsharded solve;
- ``em_step_sharded`` and ``fit_gmm_sharded`` at 1, 2 and 8 shards:
  assignments equal, mixtures within ``rtol=1e-5`` (means and stds also
  ``atol=1e-3`` µs, weights ``atol=1e-6``) of JAX's fits under
  ``shard_map`` (the sums run in another order). On the bimodal rows of
  the direct ``fit_gmm_sharded`` case the stds are held to
  ``rtol=2e-3``: both packages take a component's variance as
  ``E[z²] - E[z]²`` in f32 (the JAX fit's own formula), and with
  ``E[z]² / var`` near 4e3 there the f32 rounding of either sum order
  moves the variance by about 2.4e-4 of itself;
- ``solve_fleet(mesh=)`` on the counterpart of ``tests/test_pipeline.py``
  ``_mixed_items``: outputs and ledger keys equal to JAX's mesh run and
  to the port's run without a mesh; a mesh of 2 and one of 3 (not a
  power of two) equal the run without one;
- ``WeaverTorch(mesh=)`` ``FindAssignments`` on a synthesized store:
  equal to JAX's ``WeaverTPU(mesh=)`` and to the port without a mesh;
- ``make_mesh`` raises for more devices than the machine has, and the
  CLI's ``--mesh_devices`` refuses 3 and a mesh the machine cannot hold
  before any data loads.

The ``gpu`` case runs ``solve_fleet`` on a two-shard mesh on the card
against the run without a mesh (it skips here). JAX is imported inside
the CPU tests only.
"""

import random

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.dag import DAG
from traceweaver_tpu_torch.parallel import mesh as tm
from traceweaver_tpu_torch.spans import SKIP, Span

torch.set_num_threads(1)  # small tensors; the test workers share the cores

#: tolerances of the sharded mixtures against JAX's
MIX_RTOL = 1e-5
MIX_ATOL = {"w": 1e-6, "mu": 1e-3, "sd": 1e-3}
#: the stds of well-separated components (see the module docstring)
BIMODAL_SD_RTOL = 2e-3
LEDGER_KEYS = ("fleet_dispatches", "fleet_services", "fused_em_applied",
               "fleet_dynamism_dispatches", "compact_windows_total",
               "compact_windows_redispatched", "d2h_bytes_flags",
               "d2h_flag_fetches", "mesh_serialized_groups")


def _cpu_mesh(n):
    return tm.make_mesh(devices=["cpu"] * n)


def _jax_mesh(n):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return make_mesh(n)


# ---------------------------------------------------------------------------
# sharded solve and EM step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [16, 13])
def test_shard_solve_windows_matches_jax(B):
    from traceweaver_tpu.parallel.mesh import shard_solve_windows as j_shard

    from traceweaver_tpu_torch.algorithms.weaver_torch import ARG_ORDER, solve_windows

    arrays = ge._example_arrays(B=B, W=8, E=2, M=8)
    want = j_shard(arrays, _jax_mesh(8), n_sinkhorn=20)
    got = tm.shard_solve_windows(arrays, _cpu_mesh(8), n_sinkhorn=20)
    single = solve_windows(*(torch.as_tensor(arrays[k]) for k in ARG_ORDER),
                           n_sinkhorn=20)
    assert got[0].shape[0] == B
    for g, w, s in zip(got, want, single):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, s.numpy())


def _assert_mixtures(got, want):
    for fam in ("in", "edge", "ret"):
        for name, g, w in zip(("w", "mu", "sd"), got[fam], want[fam]):
            np.testing.assert_allclose(g, w, rtol=MIX_RTOL, atol=MIX_ATOL[name],
                                       err_msg=f"{fam} {name}")


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("B", [16, 13])
def test_em_step_sharded_matches_jax(n, B):
    from traceweaver_tpu.parallel.mesh import em_step_sharded as j_em

    arrays = ge._example_arrays(B=B, W=8, E=2, M=8)
    j_assign, j_dists = j_em(arrays, _jax_mesh(n), n_sinkhorn=20)
    assign, dists = tm.em_step_sharded(arrays, _cpu_mesh(n), n_sinkhorn=20)
    assert assign.shape == (B, 2, 8)
    assert np.array_equal(assign, j_assign)
    _assert_mixtures(dists, j_dists)
    # the synthetic (in -> e0) delay is 300 +- 30
    in_w, in_mu, _ = dists["in"]
    assert abs(float((in_w[0] * in_mu[0]).sum() / in_w[0].sum()) - 300.0) < 50.0


@pytest.mark.parametrize("n", [1, 2, 8])
def test_fit_gmm_sharded_matches_jax(n):
    import jax
    from jax.sharding import PartitionSpec as P

    from traceweaver_tpu.ops.gmm import fit_gmm_sharded as j_fit
    from traceweaver_tpu.parallel.mesh import _CHECK_KW, shard_map

    from traceweaver_tpu_torch.ops.gmm import fit_gmm_sharded

    rng = np.random.default_rng(3)
    ne, N, K = 6, 64, 3
    # bimodal, unimodal, sparse and empty rows, microsecond scale
    samples = np.concatenate([
        np.concatenate([rng.normal(1000, 30, (2, N // 2)),
                        rng.normal(5000, 80, (2, N // 2))], axis=1),
        rng.normal(250000, 400, (2, N)),
        rng.normal(40, 5, (2, N))]).astype(np.float32)
    mask = rng.random((ne, N)) < 0.8
    mask[4, 3:] = False
    mask[5] = False
    mesh = _jax_mesh(n)
    fit = jax.jit(shard_map(lambda s, m: j_fit(s, m, "data", max_k=K), mesh=mesh,
                            in_specs=(P(None, "data"), P(None, "data")),
                            out_specs=(P(), P(), P()), **{_CHECK_KW: False}))
    want = [np.asarray(a) for a in fit(samples, mask)]
    cols = np.split(np.arange(N), n)
    got = fit_gmm_sharded([torch.as_tensor(samples[:, c]) for c in cols],
                          [torch.as_tensor(mask[:, c]) for c in cols], "cpu",
                          max_k=K)
    for name, g, w in zip(("w", "mu", "sd"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=BIMODAL_SD_RTOL if name == "sd"
                                   else MIX_RTOL, atol=MIX_ATOL[name], err_msg=name)


# ---------------------------------------------------------------------------
# the fleet on a mesh
# ---------------------------------------------------------------------------

def _service_items(svc="svc", n_traces=48, burst=4, eps=("A", "B"),
                   gap=5000.0, seed=0, drop_every=0):
    """The port's counterpart of ``tests/test_pipeline.py``
    ``_service_items``: the same spans from the same seed."""
    rng = np.random.default_rng(seed)
    in_spans = []
    out_spans = {ep: [] for ep in eps}
    ta = {ep: {} for ep in eps}
    t = 0.0
    for i in range(n_traces):
        t += 30.0 if i % burst else gap
        s_in = Span(f"{svc}-t{i}", "in", t, 400.0 + 40.0 * len(eps), "op", [], svc,
                    "server")
        in_spans.append(s_in)
        dropped = drop_every and (i % drop_every == 0)
        prev_end = t + 10.0
        for ep in eps:
            if dropped:
                ta[ep][s_in.GetId()] = SKIP
                continue
            start = prev_end + 15.0 + rng.normal(0, 2)
            s_out = Span(f"{svc}-t{i}", f"out-{ep}", start, 50.0, f"op{ep}", [], svc,
                         "client")
            out_spans[ep].append(s_out)
            ta[ep][s_in.GetId()] = s_out.GetId()
            prev_end = start + 50.0
    dag = DAG()
    for ep in eps:
        dag.add_node(ep)
    for a, b in zip(eps, eps[1:]):
        dag.add_edge(a, b)
    return tf.FleetItem(svc, {"IN": in_spans}, out_spans, ta, dag)


def mixed_items():
    """Three services in three shape classes (``_mixed_items``)."""
    return [
        _service_items("alpha", n_traces=48, burst=4, eps=("A", "B"), seed=0),
        _service_items("beta", n_traces=60, burst=12, eps=("A", "B", "C"), seed=1),
        _service_items("gamma", n_traces=40, burst=4, eps=("A", "B"), seed=2,
                       drop_every=5),
    ]


def _ledger(stats):
    return {k: stats.get(k, 0.0) for k in LEDGER_KEYS}


def test_solve_fleet_mesh_matches_jax_and_single_device():
    from test_pipeline import _mixed_items

    from traceweaver_tpu.algorithms.fleet import solve_fleet as j_solve

    j_stats = {}
    want = j_solve(_mixed_items(), mesh=_jax_mesh(8), stats=j_stats)
    stats, single_stats = {}, {}
    got = tf.solve_fleet(mixed_items(), mesh=_cpu_mesh(8), stats=stats)
    single = tf.solve_fleet(mixed_items(), device="cpu", stats=single_stats)
    assert _ledger(stats) == _ledger(j_stats)
    # one coalesced flag fetch a compacted pass, billed at the padded
    # [B] flags; every padded batch is a power of two a shard
    assert stats["d2h_flag_fetches"] > 0
    assert stats["d2h_bytes_flags"] == stats["compact_windows_total"]
    assert stats["compact_windows_total"] % 8 == 0
    assert stats["mesh_serialized_groups"] == stats["fleet_dispatches"] > 1
    assert "devcols_fallbacks" not in stats
    for g, w, s in zip(got, want, single):
        assert g[0] == w[0] and g[1] == w[1] and g[2:] == w[2:]
        assert g == s


@pytest.mark.parametrize("n", [2, 3])
def test_solve_fleet_mesh_sizes_equal_single_device(n):
    """A two-shard mesh, and a mesh of three (not a power of two: its
    fallback items would run on the first device alone), equal the run
    without a mesh."""
    stats = {}
    got = tf.solve_fleet(mixed_items(), mesh=_cpu_mesh(n), stats=stats)
    single = tf.solve_fleet(mixed_items(), device="cpu", stats={})
    assert got == single
    assert stats["compact_windows_total"] % n == 0


def _record_plans(monkeypatch):
    """The batch each assignment launch is planned for (its ``plan_b``,
    else its own B), recorded where the solver calls ``assign_topk``."""
    import traceweaver_tpu_torch.algorithms.weaver_torch as tw

    real, seen = tw.assign_topk, []

    def recording(S_ot, *args, plan_b=None, **kw):
        seen.append(plan_b or S_ot.shape[0])
        return real(S_ot, *args, plan_b=plan_b, **kw)

    monkeypatch.setattr(tw, "assign_topk", recording)
    return seen


@pytest.mark.parametrize("compaction", [True, False])
def test_fleet_mesh_launches_planned_for_the_unsharded_batch(monkeypatch, compaction):
    """Every shard's launches are planned for a batch the run without a
    mesh launches, in the compacted flow and in the mesh's full
    dispatch, and the outputs are equal."""
    seen = _record_plans(monkeypatch)
    single = tf.solve_fleet(mixed_items(), device="cpu", compaction=compaction)
    single_b = set(seen)
    seen.clear()
    got = tf.solve_fleet(mixed_items(), mesh=_cpu_mesh(2), compaction=compaction)
    assert set(seen) == single_b
    assert got == single


def test_weaver_mesh_launches_planned_for_the_unsharded_batch(monkeypatch):
    """``WeaverTorch(mesh=)`` plans each shard's launches for the
    unsharded chunk's batch (not the mesh chunk's rows)."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch

    item = _service_items("alpha", n_traces=48, burst=4, seed=0)
    args = ("MaxScoreBatchSubsetWithSkips", item.svc, item.in_span_partitions,
            item.out_span_partitions, False, [], item.true_assignments, item.dag)
    seen = _record_plans(monkeypatch)
    single = WeaverTorch({}, {}, device="cpu").FindAssignments(*args)
    single_b = set(seen)
    seen.clear()
    sharded = WeaverTorch({}, {}, mesh=_cpu_mesh(8)).FindAssignments(*args)
    assert set(seen) == single_b
    assert sharded[0] == single[0] and sharded[2:] == single[2:]


def test_find_assignments_mesh_matches_jax(tmp_path):
    """``WeaverTorch(mesh=)`` against ``WeaverTPU(mesh=)`` and the port
    without a mesh on a synthesized Alibaba store (both packages load the
    same files)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.algorithms.weaver_tpu import WeaverTPU
    from traceweaver_tpu.ingest import build_service_problem as j_build
    from traceweaver_tpu.ingest import infer_invocation_dag as j_dag
    from traceweaver_tpu.ingest import load_corpus as j_load
    from traceweaver_tpu.metrics import get_ground_truth as j_truth

    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.ingest import build_service_problem, infer_invocation_dag
    from traceweaver_tpu_torch.ingest import load_corpus
    from traceweaver_tpu_torch.metrics import get_ground_truth

    (graph,) = synthesize_corpus(str(tmp_path), n_graphs=1, traces_per_graph=60, seed=5,
                                 base_gap_ms=300, n_services=10)
    # ``-loop`` service names draw from the global ``random``: seed it
    # alike before each load
    random.seed(0)
    store = load_corpus(graph, fix=5, max_traces=61, cache=False)
    random.seed(0)
    j_store = j_load(graph, fix=5, max_traces=61, cache=False, native="never")
    solved = 0
    for svc in sorted(store.out_spans_by_process):
        prob = build_service_problem(store, svc)
        if prob.skipped:
            continue
        truth = get_ground_truth(prob.in_span_partitions, prob.out_span_partitions)
        dag = infer_invocation_dag(prob.in_span_partitions, prob.out_span_partitions,
                                   truth, store)
        args = ("MaxScoreBatchSubsetWithSkips", svc, prob.in_span_partitions,
                prob.out_span_partitions, False, [], truth, dag)
        sharded = WeaverTorch(store.all_spans, store.all_processes,
                              mesh=_cpu_mesh(8)).FindAssignments(*args)
        single = WeaverTorch(store.all_spans, store.all_processes,
                             device="cpu").FindAssignments(*args)
        assert sharded[0] == single[0] and sharded[2:] == single[2:], svc
        j_prob = j_build(j_store, svc)
        j_tr = j_truth(j_prob.in_span_partitions, j_prob.out_span_partitions)
        j_args = ("MaxScoreBatchSubsetWithSkips", svc, j_prob.in_span_partitions,
                  j_prob.out_span_partitions, False, [], j_tr,
                  j_dag(j_prob.in_span_partitions, j_prob.out_span_partitions, j_tr,
                        j_store))
        j_out = WeaverTPU(j_store.all_spans, j_store.all_processes,
                          mesh=_jax_mesh(8)).FindAssignments(*j_args)
        assert sharded[0] == j_out[0] and sharded[2] == j_out[2], svc
        solved += 1
    assert solved >= 2


# ---------------------------------------------------------------------------
# mesh construction and the CLI's refusals
# ---------------------------------------------------------------------------

def test_make_mesh_devices_and_refusals(monkeypatch):
    m = tm.make_mesh(devices=["cpu"] * 4, axis="windows")
    assert m.size == 4 and m.axis_names == ("windows",)
    assert tm.make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(RuntimeError):
        tm.make_mesh(5, devices=["cpu"] * 4)
    # no CPU fall-back: more cards than the machine has raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tm.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="2-device mesh"):
        tm.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tm.make_mesh(1)


@pytest.mark.parametrize("n_rows", [1, 5, 8, 13, 64, 100])
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_bucket_rows_per_shard_matches_jax(n_rows, n_shards):
    from traceweaver_tpu.parallel.mesh import bucket_rows_per_shard as j_bucket

    assert tm.bucket_rows_per_shard(n_rows, n_shards) == j_bucket(n_rows, n_shards)


def test_put_sharded_and_coalesce():
    arrays = ge._example_arrays(B=8, W=8, E=2, M=8)
    mesh = _cpu_mesh(4)
    placed = tm.put_sharded(arrays, mesh)
    assert [t.shape[0] for t in placed["in_start"]] == [2, 2, 2, 2]
    # a replicated table is one copy per distinct device
    assert all(t is placed["edge_wt"][0] for t in placed["edge_wt"])
    back = tm.coalesce_to_device0(placed["in_start"], mesh)
    assert np.array_equal(back.numpy(), arrays["in_start"])
    with pytest.raises(ValueError):
        tm.put_sharded({k: v[:7] for k, v in arrays.items()}, mesh)


@pytest.mark.parametrize("flags", [["--mesh_devices", "3", "--device", "cpu"],
                                   ["--mesh_devices", "2"]])
def test_cli_mesh_devices_refused_before_data_loads(flags, monkeypatch, tmp_path):
    from traceweaver_tpu_torch.runtime import cli
    from traceweaver_tpu_torch.runtime import executor as tx

    if "--device" not in flags:
        # a machine with one card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    loads = []
    monkeypatch.setattr(tx, "load_corpus", lambda *a, **k: loads.append(a))
    rc = cli.main(["--absolute_path", str(tmp_path / "absent"), "--fix", "5",
                   "--cache_rate", "0", "--results_directory", str(tmp_path / "out"),
                   *flags])
    assert rc != 0
    assert not loads and not (tmp_path / "out").exists()
    with pytest.raises(ValueError):
        tm.mesh_for(3, "cpu")


def test_executor_mesh_on_cpu():
    """The executor's and the campaign's mesh (``mesh_for``): none at 0,
    N CPU shards with the CPU device."""
    from traceweaver_tpu_torch.campaign.plan import mini_plan
    from traceweaver_tpu_torch.campaign.runner import plan_mesh

    assert tm.mesh_for(0, "cpu") is None
    mesh = tm.mesh_for(4, "cpu")
    assert mesh.size == 4 and {d.type for d in mesh.devices} == {"cpu"}
    assert plan_mesh(mini_plan(devices=1), torch.device("cpu")) is None
    assert plan_mesh(mini_plan(devices=2), torch.device("cpu")).size == 2


@pytest.mark.gpu
def test_solve_fleet_two_shard_card_mesh():
    """``solve_fleet`` on the two-shard mesh ``["cuda:0"] * 2`` equals the
    run without a mesh, item for item, and shards its batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stats = {}
    got = tf.solve_fleet(mixed_items(), mesh=tm.make_mesh(devices=["cuda:0"] * 2),
                         stats=stats)
    single = tf.solve_fleet(mixed_items())
    assert got == single
    assert stats["compact_windows_total"] % 2 == 0
    assert stats["d2h_bytes_flags"] == stats["compact_windows_total"]
