"""The port's solver vs the JAX package's on the same inputs (CPU).

- packed window tensors: byte-identical (host numpy, same code path);
- packed int32 solver blocks and convergence flags: exactly equal on
  the entry example (no rounding decision there sits on a near tie);
- on tensors whose blocks do hold exact-mass ties (the fused-kernel test
  tensors: identical durations and one shared delay law; a wider entry
  example whose backward sweeps leave rows without a feasible
  candidate, where the plan is f32 noise around 1e9): convergence flags
  equal, and every OT call of the port's solve equals the JAX
  composition on the same block up to near ties;
- the slice end to end (``FindAssignments`` on a 256-request cut of
  config ``synth-async-8k``): >= 99% identical (span, endpoint)
  assignments and accuracy within 0.5 pt, since XLA and torch order
  their log-sum-exps differently and exact-mass near ties may flip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import networkx as nx

import __graft_entry__
from traceweaver_tpu.algorithms import timing as jtiming
from traceweaver_tpu.algorithms import weaver_tpu as jw
from traceweaver_tpu.metrics.accuracy import accuracy_for_service as j_accuracy
from traceweaver_tpu.metrics.scorecard import _make_service
from traceweaver_tpu.ops.pallas_sinkhorn import assign_topk_jnp
from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as j_sinkhorn

from traceweaver_tpu_torch.algorithms import timing as ttiming
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service as t_accuracy
from traceweaver_tpu_torch.metrics.synth import chain_edges, make_service
from traceweaver_tpu_torch.ops.compare import assign_diff_report, topk_diff_report

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

ARG_ORDER = __graft_entry__.ARG_ORDER
NEG = -1.0e9


def _both_services(n, burst, seed=0, n_eps=3, jitter_us=10.0):
    kw = dict(n_traces=n, n_eps=n_eps, spacing_us=6000.0, burst=burst,
              jitter_us=jitter_us)
    pj = _make_service("svc", rng=np.random.default_rng(seed), **kw)
    edges = chain_edges("svc", n_eps)
    dag = nx.DiGraph()
    dag.add_nodes_from(pj["out_parts"])
    dag.add_edges_from(edges)
    pj["dag"] = dag
    pt = make_service("svc", rng=np.random.default_rng(seed), dag_edges=edges, **kw)
    return pj, pt


@pytest.mark.parametrize("case", ["plain", "padded", "forced"])
def test_pack_problem_byte_identical(case):
    pj, pt = _both_services(96, burst=24)
    in_ep = next(iter(pj["in_parts"]))
    jin = sorted(pj["in_parts"][in_ep], key=lambda s: (s.start_mus, s.end_mus))
    tin = sorted(pt["in_parts"][in_ep], key=lambda s: (s.start_mus, s.end_mus))
    out_eps = jw.WeaverTPU._topo_out_eps(pj["out_parts"], pj["dag"])
    assert out_eps == tw.WeaverTorch._topo_out_eps(pt["out_parts"], pt["dag"])
    dists = jtiming.estimate_edge_params(pj["in_parts"], pj["out_parts"],
                                         pj["dag"], 0, len(jin))
    kw = dict(max_window=16)
    if case == "padded":
        kw.update(pad_w=32, pad_b=16, pad_m=64, pad_e=4)
    if case == "forced":
        forced = {ep: {s.GetId() for s in jin[::7]} for ep in out_eps[:2]}
        kw.update(force_skip_ids=forced)
    pkj = jw.pack_problem(jin, pj["out_parts"], out_eps, dists, in_ep,
                          pj["dag"], **kw)
    pkt = tw.pack_problem(tin, pt["out_parts"], out_eps,
                          ttiming.dists_from_numpy(dists), in_ep, pt["dag"], **kw)
    assert set(pkj.arrays) == set(pkt.arrays)
    for k, a in pkj.arrays.items():
        b = pkt.arrays[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert pkj.windows == pkt.windows and len(pkj.windows) > 1
    assert list(pkj.in_ids) == list(pkt.in_ids)
    for e in range(len(out_eps)):
        assert list(pkj.out_id_array(e)) == list(pkt.out_id_array(e))


def _fused_kernel_test_arrays():
    """tests/test_fused_kernel.py's synthetic solve tensors."""
    rng = np.random.default_rng(0)
    B, E, W, M, K = 2, 2, 96, 96, 3
    in_start = np.sort(rng.uniform(0, 3000, (B, W)), axis=1).astype(np.float32)
    out_start = np.sort(rng.uniform(0, 3100, (B, E, M)), axis=2).astype(np.float32)
    pred_mask = np.zeros((E, E), bool)
    pred_mask[1, 0] = True
    wt = np.zeros((E, E, K), np.float32)
    wt[..., 0] = 1
    iwt = np.zeros((E, K), np.float32)
    iwt[:, 0] = 1
    imu = np.full((E, K), 10.0, np.float32)
    isd = np.full((E, K), 5.0, np.float32)
    return dict(
        in_start=in_start, in_end=in_start + 200, in_valid=np.ones((B, W), bool),
        out_start=out_start, out_end=out_start + 5, out_valid=np.ones((B, E, M), bool),
        skip_cap=np.zeros((B, E), np.float32), force_skip=np.zeros((B, E, W), bool),
        pred_mask=pred_mask, root_mask=np.array([True, False]),
        is_last=np.array([False, True]), edge_wt=wt,
        edge_mu=np.full((E, E, K), 10.0, np.float32),
        edge_sd=np.full((E, E, K), 5.0, np.float32),
        in_wt=iwt, in_mu=imu, in_sd=isd, ret_wt=iwt, ret_mu=imu, ret_sd=isd)


CASES = {
    "entry": (__graft_entry__._example_arrays,
              dict(n_sinkhorn=40, n_sweeps=5, sinkhorn_tol=1e-3)),
    "entry-bounded": (__graft_entry__._example_arrays,
                      dict(n_sinkhorn=40, n_sweeps=5, sinkhorn_tol=1e-3,
                           max_preds=1, max_succs=1)),
}
TIED_CASES = {
    "fused-kernel-test": (_fused_kernel_test_arrays,
                          dict(n_sinkhorn=10, n_sweeps=2, sinkhorn_tol=1e-3)),
    "entry-wide": (lambda: __graft_entry__._example_arrays(B=4, W=32, M=48, seed=3),
                   dict(n_sinkhorn=40, n_sweeps=5, sinkhorn_tol=1e-3)),
}


def _impl_both(arrays, kw):
    """The port's ``_solve_windows_impl`` and JAX's fleet entry (packed
    block, converged flags) on the same arrays."""
    B = arrays["in_start"].shape[0]
    tables = [arrays[k] for k in ARG_ORDER[8:]]
    ref_packed, ref_conv = jw.solve_windows_fleet(
        *(jnp.asarray(arrays[k]) for k in ARG_ORDER[:8]),
        jnp.zeros(B, jnp.int32), *(jnp.asarray(t)[None] for t in tables), **kw)
    outs = tw._solve_windows_impl(
        *(torch.as_tensor(arrays[k]) for k in ARG_ORDER[:8]),
        torch.zeros(B, dtype=torch.int64),
        *(torch.as_tensor(t)[None] for t in tables), topk=tw.DEFAULT_TOPK,
        epsilon=1.0, **kw)
    return outs, np.asarray(ref_packed), np.asarray(ref_conv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_windows_packed_and_flags_equal(name):
    make, kw = CASES[name]
    arrays = make()
    got = tw.solve_windows_packed(*(torch.as_tensor(arrays[k]) for k in ARG_ORDER),
                                  **kw).numpy()
    outs, ref_packed, ref_conv = _impl_both(arrays, kw)
    assert got.dtype == ref_packed.dtype == np.int32
    assert np.array_equal(got, ref_packed)
    assert np.array_equal(tw._pack_solver_outputs(*outs[:4]).numpy(), ref_packed)
    assert np.array_equal(outs[-1].numpy(), ref_conv)


@pytest.mark.parametrize("name", sorted(TIED_CASES))
def test_solver_on_tied_blocks_differs_only_at_ties(name, monkeypatch):
    """Blocks with exact-mass ties: the port's and XLA's plans differ in
    the last bits, so a tie may break the other way and the sweeps then
    diverge. Held instead: equal convergence flags, and for every OT
    call of the port's solve, JAX's ``assign_topk_jnp`` on the very same
    block gives the same assignment and top-k except at near ties (or
    rows contending with such a row for one column)."""
    make, kw = TIED_CASES[name]
    arrays = make()
    calls = []
    real = tw.assign_topk

    def recording(*args, **akw):
        out = real(*args, **akw)
        calls.append((args, akw, out))
        return out

    monkeypatch.setattr(tw, "assign_topk", recording)
    outs, _, ref_conv = _impl_both(arrays, kw)
    assert np.array_equal(outs[-1].numpy(), ref_conv)
    assert calls
    for (S, rm, cm, in_v, cv, cap, W), akw, (a, tk) in calls:
        ref_a, ref_tk, plans = [], [], []
        for b in range(S.shape[0]):
            blk = [jnp.asarray(x[b].numpy()) for x in (S, rm, cm, in_v, cv, cap)]
            ra, rtk = assign_topk_jnp(*blk, W, epsilon=akw["epsilon"],
                                      n_iters=akw["n_iters"], tol=akw["tol"],
                                      topk=akw["topk"],
                                      min_topk_mass=akw["min_topk_mass"])
            ref_a.append(np.asarray(ra))
            ref_tk.append(np.asarray(rtk))
            plans.append(np.asarray(j_sinkhorn(*blk[:3], epsilon=akw["epsilon"],
                                               n_iters=akw["n_iters"],
                                               tol=akw["tol"]))[:W])
        plans = np.stack(plans)
        st = assign_diff_report(a.numpy(), np.stack(ref_a), plans)
        assert st["unexplained"] == 0, st
        masked = np.where(cv.numpy()[:, None, :], plans, NEG)
        _, tk_bad = topk_diff_report(tk.numpy(), np.stack(ref_tk), masked,
                                     akw["min_topk_mass"])
        assert tk_bad == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_em_packed_equal(name):
    make, kw = CASES[name]
    arrays = make()
    got = tw.solve_em_packed(*(torch.as_tensor(arrays[k]) for k in ARG_ORDER),
                             **kw).numpy()
    ref = np.asarray(jw.solve_em_packed(*(jnp.asarray(arrays[k]) for k in ARG_ORDER),
                                        **kw))
    assert np.array_equal(got, ref)


def test_em_family_samples_equal():
    arrays = __graft_entry__._example_arrays()
    rng = np.random.default_rng(2)
    B, E, W = 8, 3, 16
    assign = rng.integers(-1, 17, size=(B, E, W)).astype(np.int32)
    keys = ("in_start", "in_end", "in_valid", "out_start", "out_end",
            "pred_mask", "root_mask")
    sj, mj = jw.em_family_samples(jnp.asarray(assign),
                                  *(jnp.asarray(arrays[k]) for k in keys))
    st, mt = tw.em_family_samples(torch.as_tensor(assign),
                                  *(torch.as_tensor(arrays[k]) for k in keys))
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert np.array_equal(st.numpy()[mt.numpy()], np.asarray(sj)[np.asarray(mj)])


def test_find_assignments_slice_matches_jax():
    """The slice end to end on a 256-request cut of synth-async-8k."""
    pj, pt = _both_services(256, burst=256)
    args = ("MaxScoreBatchSubsetWithSkips", "svc")
    oj = jw.WeaverTPU({}, {}).FindAssignments(
        *args, pj["in_parts"], pj["out_parts"], False, [], pj["truth"], pj["dag"])
    algo = tw.WeaverTorch({}, {}, device="cpu")
    ot = algo.FindAssignments(
        *args, pt["in_parts"], pt["out_parts"], False, [], pt["truth"], pt["dag"])
    assert algo.stats.get("fused_em_applied") == 1.0
    pairs = [(ep, i) for ep in oj[0] for i in oj[0][ep]]
    assert len(pairs) == 3 * 256
    same = sum(ot[0][ep][i] == oj[0][ep][i] for ep, i in pairs) / len(pairs)
    assert same >= 0.99
    acc_j = j_accuracy(oj[0], pj["truth"], pj["in_parts"])
    acc_t = t_accuracy(ot[0], pt["truth"], pt["in_parts"])
    assert abs(acc_j - acc_t) <= 0.005
    assert acc_t > 0.9
    assert ot[3] == oj[3] == 256


def test_find_assignments_host_refit_path(monkeypatch):
    """A small dispatch budget (in both packages) splits the windows into
    several dispatches: the fused EM does not apply and the host refit
    runs."""
    monkeypatch.setattr(jw, "CHUNK_ELEMS", 2048)
    monkeypatch.setattr(tw, "CHUNK_ELEMS", 2048)
    pj, pt = _both_services(160, burst=40, seed=1)
    args = ("MaxScoreBatchSubsetWithSkips", "svc")
    jalgo = jw.WeaverTPU({}, {}, max_window=8)
    oj = jalgo.FindAssignments(*args, pj["in_parts"], pj["out_parts"], False, [],
                               pj["truth"], pj["dag"])
    talgo = tw.WeaverTorch({}, {}, max_window=8, device="cpu")
    ot = talgo.FindAssignments(*args, pt["in_parts"], pt["out_parts"], False, [],
                               pt["truth"], pt["dag"])
    assert not talgo.stats.get("fused_em_applied")
    assert not jalgo.stats.get("fused_em_applied")
    assert "refit_s" in talgo.stats
    pairs = [(ep, i) for ep in oj[0] for i in oj[0][ep]]
    same = sum(ot[0][ep][i] == oj[0][ep][i] for ep, i in pairs) / len(pairs)
    assert same >= 0.99
    assert abs(j_accuracy(oj[0], pj["truth"], pj["in_parts"])
               - t_accuracy(ot[0], pt["truth"], pt["in_parts"])) <= 0.005
