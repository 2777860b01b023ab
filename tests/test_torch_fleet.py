"""The port's fleet solve vs the JAX package's on the same inputs (CPU).

- the fleet device entry points (``solve_windows_fleet``,
  ``refit_fleet_params``, ``solve_em_fleet``) on synthetic fleet tensors
  with two services' tables (P = 2) and one service's endpoints padded
  (E_pad > E): packed blocks and convergence flags equal, refit tables
  within a stated tolerance;
- convergence compaction equals the port's own uncompacted dispatch bit
  for bit, for one and two passes;
- ``solve_fleet`` on a 128-request cut of config ``synth-fleet-8svc``
  against JAX ``solve_fleet`` on the same spans: the same dispatch
  grouping and compaction counts, >= 99% equal assignments and accuracy
  within 0.5 pt per service; against the port's per-service
  ``WeaverTorch``; the budget and no-DAG fallbacks;
- the solve supervisor: retry, quarantine, and which errors propagate.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_synth import run_fleet, synth_fleet_services
from traceweaver_tpu.algorithms import weaver_tpu as jw
from traceweaver_tpu.algorithms.timing import estimate_edge_params
from traceweaver_tpu.metrics.accuracy import accuracy_for_service as j_accuracy
from traceweaver_tpu.ops.pallas_sinkhorn import assign_topk_jnp
from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as j_sinkhorn

from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.algorithms.timing import dists_from_numpy
from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service as t_accuracy
from traceweaver_tpu_torch.metrics.synth import chain_edges, make_service, synth_fleet_8svc
from traceweaver_tpu_torch.ops.compare import assign_diff_report, topk_diff_report
from traceweaver_tpu_torch.synth.transforms import create_cache_hits
from traceweaver_tpu_torch.runtime import faults as tfaults
from traceweaver_tpu_torch.spans import NA

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)  # small tensors; the test workers share the cores

N_TRACES = 128
HYPERS = dict(epsilon=1.0, n_sinkhorn=20, sinkhorn_tol=1e-3, max_preds=1,
              max_succs=1)
CPU = torch.device("cpu")
TABLE_KEYS = tf._TABLE_KEYS
BATCH_KEYS = tf._BATCH_KEYS


# ---------------------------------------------------------------------------
# fleet tensors
# ---------------------------------------------------------------------------

def _fleet_tensors(B=8, E=3, W=8, M=8, K=3, seed=0, n_easy=3):
    """Two services in one batch: rows [0, B/2) are service 0 (a chain of
    E endpoints), rows [B/2, B) service 1 (E - 1 chained endpoints; its
    last endpoint is padding: no valid columns, no masks). In each half
    the first ``n_easy // 2 + 1`` windows hold well-separated spans (a
    fixed point within two sweeps), the rest overlapping noisy spans."""
    rng = np.random.default_rng(seed)
    half = B // 2
    in_start = np.zeros((B, W), np.float32)
    in_end = np.zeros((B, W), np.float32)
    out_start = np.zeros((B, E, M), np.float32)
    out_valid = np.ones((B, E, M), bool)
    for b in range(B):
        if b % half < n_easy // 2 + 1:
            starts = np.arange(W, dtype=np.float32) * 1000.0
            in_start[b], in_end[b] = starts, starts + 800.0
            for e in range(E):
                out_start[b, e] = starts + 10.0 * (e + 1) + rng.normal(0, 0.5, W)
        else:
            starts = np.sort(rng.uniform(0, 200, W)).astype(np.float32)
            in_start[b], in_end[b] = starts, starts + 400.0
            for e in range(E):
                out_start[b, e] = np.sort(starts + 10.0 * (e + 1)
                                          + rng.normal(0, 30, W))
    out_valid[half:, E - 1] = False
    out_start[half:, E - 1] = 0.0
    batch = dict(in_start=in_start, in_end=in_end, in_valid=np.ones((B, W), bool),
                 out_start=out_start, out_end=out_start + 8.0, out_valid=out_valid,
                 skip_cap=np.zeros((B, E), np.float32),
                 force_skip=np.zeros((B, E, W), bool))
    pidx = np.repeat(np.arange(2, dtype=np.int32), half)
    pred = np.zeros((2, E, E), bool)
    for e in range(1, E):
        pred[0, e, e - 1] = True
    for e in range(1, E - 1):
        pred[1, e, e - 1] = True
    root = np.zeros((2, E), bool)
    root[:, 0] = True
    last = np.zeros((2, E), bool)
    last[0, E - 1] = True
    last[1, E - 2] = True
    ew = np.zeros((2, E, E, K), np.float32)
    ew[..., 0] = 1
    emu = np.stack([np.full((E, E, K), 10.0), np.full((E, E, K), 12.0)]).astype(np.float32)
    esd = np.stack([np.full((E, E, K), 5.0), np.full((E, E, K), 6.0)]).astype(np.float32)
    iw = np.zeros((2, E, K), np.float32)
    iw[..., 0] = 1
    imu = np.stack([np.full((E, K), 10.0), np.full((E, K), 11.0)]).astype(np.float32)
    isd = np.stack([np.full((E, K), 5.0), np.full((E, K), 4.0)]).astype(np.float32)
    for t in (ew, iw):      # the padded endpoint has the packer's empty tables
        t[1, E - 1] = 0.0
    params = dict(pred_mask=pred, root_mask=root, is_last=last,
                  edge_wt=ew, edge_mu=emu, edge_sd=esd,
                  in_wt=iw, in_mu=imu, in_sd=isd,
                  ret_wt=iw.copy(), ret_mu=imu.copy(), ret_sd=isd.copy())
    window_rows = np.arange(B, dtype=np.int32).reshape(2, half)
    window_valid = np.ones((2, half), bool)
    return batch, params, pidx, window_rows, window_valid


def _jax_args(batch, pidx):
    return tuple(jnp.asarray(batch[k]) for k in BATCH_KEYS) + (jnp.asarray(pidx),)


def _torch_args(batch, pidx):
    return tuple(torch.as_tensor(batch[k]) for k in BATCH_KEYS) + (torch.as_tensor(pidx),)


def _tables(params, lib):
    return tuple((jnp.asarray if lib == "jax" else torch.as_tensor)(params[k])
                 for k in TABLE_KEYS)


def test_solve_windows_fleet_matches_jax():
    batch, params, pidx, _, _ = _fleet_tensors()
    ref, ref_conv = jw.solve_windows_fleet(*_jax_args(batch, pidx),
                                           *_tables(params, "jax"), n_sweeps=5,
                                           **HYPERS)
    got, conv = tw.solve_windows_fleet(*_torch_args(batch, pidx),
                                       *_tables(params, "torch"), n_sweeps=5, **HYPERS)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(conv.numpy(), np.asarray(ref_conv))
    # the padded endpoint of service 1 assigns nothing
    half = batch["in_start"].shape[0] // 2
    assert (got.numpy()[half:, -1, :, 0] == batch["out_start"].shape[2]).all()


def _refit_args(batch, pidx, wr, wv, params, lib, assign):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    keys = ("in_start", "in_end", "in_valid", "out_start", "out_end")
    tables = _tables(params, lib)
    return ((conv(assign),) + tuple(conv(batch[k]) for k in keys)
            + (conv(pidx), conv(wr), conv(wv)) + tables[:2] + tables[3:])


def test_refit_fleet_params_matches_jax():
    """Same pass-0 assignments in: the nine refit tables agree within
    f32 EM round-off (rtol 1e-4, atol 1e-3 µs) in both packages."""
    batch, params, pidx, wr, wv = _fleet_tensors()
    packed, _ = tw.solve_windows_fleet(*_torch_args(batch, pidx),
                                       *_tables(params, "torch"), n_sweeps=5, **HYPERS)
    assign = packed[..., 0].numpy()
    ref = jw.refit_fleet_params(*_refit_args(batch, pidx, wr, wv, params, "jax", assign))
    got = tw.refit_fleet_params(*_refit_args(batch, pidx, wr, wv, params, "torch", assign))
    assert len(got) == len(ref) == 9
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-3)


def _ot_calls_tie_equal(calls):
    """Every recorded OT call of a port solve against JAX's
    ``assign_topk_jnp`` on the very same block: the same assignment and
    top-k except at near ties (``ops/compare.py``)."""
    for (S, rm, cm, in_v, cv, cap, W), akw, (a, tk) in calls:
        ref_a, ref_tk, plans = [], [], []
        for b in range(S.shape[0]):
            blk = [jnp.asarray(x[b].numpy()) for x in (S, rm, cm, in_v, cv, cap)]
            kw = dict(epsilon=akw["epsilon"], n_iters=akw["n_iters"], tol=akw["tol"])
            ra, rtk = assign_topk_jnp(*blk, W, topk=akw["topk"],
                                      min_topk_mass=akw["min_topk_mass"], **kw)
            ref_a.append(np.asarray(ra))
            ref_tk.append(np.asarray(rtk))
            plans.append(np.asarray(j_sinkhorn(*blk[:3], **kw))[:W])
        plans = np.stack(plans)
        assert assign_diff_report(a.numpy(), np.stack(ref_a), plans)["unexplained"] == 0
        masked = np.where(cv.numpy()[:, None, :], plans, -1.0e9)
        assert topk_diff_report(tk.numpy(), np.stack(ref_tk), masked,
                                akw["min_topk_mass"])[1] == 0


def test_solve_em_fleet_matches_jax(monkeypatch):
    """Equal flags; the packed block equal up to near ties: the refit
    tables agree to a few ulps (above), and pass 1's scores, built from
    such generic mixture parameters, carry near-tied rows whose OT
    choice may flip. Held: JAX's pass 1 on JAX's refit tables equals
    its ``solve_em_fleet`` bit for bit, and every OT call of the port's
    pass 1 on those tables equals JAX's composition on the same block up
    to near ties."""
    batch, params, pidx, wr, wv = _fleet_tensors()
    ref, ref_conv = jw.solve_em_fleet(*_jax_args(batch, pidx), jnp.asarray(wr),
                                      jnp.asarray(wv), *_tables(params, "jax"),
                                      n_sweeps=5, **HYPERS)
    got, conv = tw.solve_em_fleet(*_torch_args(batch, pidx), torch.as_tensor(wr),
                                  torch.as_tensor(wv), *_tables(params, "torch"),
                                  n_sweeps=5, **HYPERS)
    ref = np.asarray(ref)
    assert np.array_equal(conv.numpy(), np.asarray(ref_conv))
    assert (got.numpy() != ref).any(axis=-1).mean() <= 0.02

    pass0, _ = jw.solve_windows_fleet(*_jax_args(batch, pidx), *_tables(params, "jax"),
                                      n_sweeps=5, **HYPERS)
    refit = jw.refit_fleet_params(*_refit_args(batch, pidx, wr, wv, params, "jax",
                                               np.asarray(pass0)[..., 0]))
    pass1, _ = jw.solve_windows_fleet(*_jax_args(batch, pidx),
                                      *_tables(params, "jax")[:3], *refit,
                                      n_sweeps=5, **HYPERS)
    assert np.array_equal(np.asarray(pass1), ref)

    calls, real = [], tw.assign_topk

    def recording(*args, **akw):
        out = real(*args, **akw)
        calls.append((args, akw, out))
        return out

    monkeypatch.setattr(tw, "assign_topk", recording)
    tables = _tables(params, "torch")[:3] + tuple(torch.tensor(np.asarray(t))
                                                   for t in refit)
    _, conv1 = tw.solve_windows_fleet(*_torch_args(batch, pidx), *tables,
                                      n_sweeps=5, **HYPERS)
    assert np.array_equal(conv1.numpy(), np.asarray(ref_conv))
    assert calls
    _ot_calls_tie_equal(calls)


def test_truncate_rows_matches_jax():
    """The fleet packer's row cut of the id maps, against the JAX copy."""
    pj = synth_fleet_services(40)[0]
    pt = synth_fleet_8svc(40)[0]
    in_ep = next(iter(pj["in_parts"]))
    out_eps = jw.WeaverTPU._topo_out_eps(pj["out_parts"], pj["dag"])
    dists = estimate_edge_params(pj["in_parts"], pj["out_parts"], pj["dag"], 0, 40)
    kw = dict(max_window=8, pad_b=16, pad_e=4)
    pkj = jw.pack_problem(pj["in_parts"][in_ep], pj["out_parts"], out_eps, dists,
                          in_ep, pj["dag"], **kw)
    pkt = tw.pack_problem(pt["in_parts"][in_ep], pt["out_parts"], out_eps,
                          dists_from_numpy(dists), in_ep, pt["dag"], **kw)
    n = len(pkt.windows)
    assert n < 16
    pkj.truncate_rows(n)
    pkt.truncate_rows(n)
    for e in range(len(out_eps)):
        got, ref = pkt.out_id_array(e), pkj.out_id_array(e)
        assert len(got) == n * pkt.M
        assert list(got) == list(ref)


# ---------------------------------------------------------------------------
# convergence compaction (port against itself)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [1, 2, 3])
def test_compacted_pass_bit_identical(warm):
    batch, params, pidx, _, _ = _fleet_tensors()
    tables = _tables(params, "torch")
    full, _ = tw.solve_windows_fleet(*_torch_args(batch, pidx), *tables,
                                     n_sweeps=5, **HYPERS)
    stats = {}
    compacted = tf._compacted_pass(batch, pidx, tables, 5, warm, HYPERS, stats, CPU)
    assert np.array_equal(full.numpy(), compacted)
    assert stats["compact_windows_total"] == batch["in_start"].shape[0]
    if warm == 1:  # sweep 0 always reports "changed"
        assert stats["compact_windows_redispatched"] == stats["compact_windows_total"]
    else:
        assert stats["compact_windows_redispatched"] < stats["compact_windows_total"]


def test_compacted_two_pass_equals_solve_em_fleet():
    batch, params, pidx, wr, wv = _fleet_tensors()
    fused, _ = tw.solve_em_fleet(*_torch_args(batch, pidx), torch.as_tensor(wr),
                                 torch.as_tensor(wv), *_tables(params, "torch"),
                                 n_sweeps=5, **HYPERS)
    compacted = tf._solve_group_compacted(batch, pidx, params, wr, wv, n_passes=2,
                                          n_sweeps=5, warm=2, hypers=HYPERS,
                                          stats={}, device=CPU)
    assert np.array_equal(fused.numpy(), compacted)


# ---------------------------------------------------------------------------
# solve_fleet on a cut of synth-fleet-8svc
# ---------------------------------------------------------------------------

LEDGER_KEYS = ("fleet_dispatches", "fleet_services", "fused_em_applied",
               "fleet_dynamism_dispatches", "compact_windows_total")


def _items(probs, **kw):
    return [tf.FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                         p["dag"], **kw) for p in probs]


def _agreement(a, b):
    pairs = [(ep, i) for ep in b for i in b[ep]]
    return sum(a[ep][i] == b[ep][i] for ep, i in pairs) / len(pairs)


@pytest.fixture(scope="module")
def port_fleet():
    probs = synth_fleet_8svc(N_TRACES)
    stats = {}
    cells = [0.0] * len(probs)
    out = tf.solve_fleet(_items(probs), stats=stats, item_cells=cells, device="cpu")
    return probs, out, stats, cells


def test_corpus_matches_jax():
    """Same seeds, same spans, same cache hits in both packages."""
    for pj, pt in zip(synth_fleet_services(N_TRACES), synth_fleet_8svc(N_TRACES)):
        assert pj["service"] == pt["service"]
        assert pj["truth"] == pt["truth"]
        assert set(pj["dag"].edges) == {(u, v) for u in pt["dag"]
                                         for v in pt["dag"].successors(u)}
        for parts in ("in_parts", "out_parts"):
            assert list(pj[parts]) == list(pt[parts])
            for ep in pj[parts]:
                assert ([(s.GetId(), s.start_mus, s.duration_mus) for s in pj[parts][ep]]
                        == [(s.GetId(), s.start_mus, s.duration_mus)
                            for s in pt[parts][ep]])


def test_solve_fleet_matches_jax(port_fleet):
    probs, out, stats, cells = port_fleet
    ref_stats = {}
    ref = run_fleet(synth_fleet_services(N_TRACES), ref_stats)
    for k in LEDGER_KEYS:
        assert stats.get(k) == ref_stats.get(k), k
    assert stats["fleet_services"] == 8 and stats["fleet_dynamism_dispatches"] >= 1
    assert all(c > 0 for c in cells)
    for p, o, r in zip(probs, out, ref):
        assert len(o) == 6 and o[3] == r[3] == N_TRACES
        assert _agreement(o[0], r[0]) >= 0.99, p["service"]
        acc_t = t_accuracy(o[0], p["truth"], p["in_parts"])
        acc_j = j_accuracy(r[0], p["truth"], p["in_parts"])
        assert abs(acc_t - acc_j) <= 0.005, (p["service"], acc_t, acc_j)


def _perturbed_agreement(prob, monkeypatch):
    """Share of a service's (endpoint, span) pairs that its CPU solve
    keeps when every valid score is scaled by 1 + 1e-6 * N(0, 1): the
    size of the last-bit differences between the card's kernels and the
    CPU's plain versions."""
    real, noisy = tw.assign_topk, {"on": False}
    gen = torch.Generator().manual_seed(0)

    def perturbed(S, *args, **kw):
        if noisy["on"]:
            S = torch.where(S > tw.NEG / 2,
                            S * (1 + 1e-6 * torch.randn(S.shape, generator=gen)), S)
        return real(S, *args, **kw)

    monkeypatch.setattr(tw, "assign_topk", perturbed)
    outs = []
    for on in (False, True):
        noisy["on"] = on
        outs.append(tw.WeaverTorch({}, {}, device="cpu").FindAssignments(
            "MaxScoreBatchSubsetWithSkips", prob["service"], prob["in_parts"],
            prob["out_parts"], False, [], prob["truth"], prob["dag"])[0])
    return _agreement(outs[1], outs[0])


@pytest.mark.parametrize("index", range(8))
def test_fleet_config_is_stable_under_last_bit_noise(index, monkeypatch):
    """The card-vs-CPU agreement check of ``chip_smoke.py`` holds each
    service to >= 0.99; it is meaningful only where no assignment hangs
    on a near tie: every service of the config."""
    prob = synth_fleet_8svc(N_TRACES)[index]
    assert _perturbed_agreement(prob, monkeypatch) == 1.0, prob["service"]


@pytest.mark.parametrize("jitter_us", [10.0, 35.0])
def test_cache_service_with_more_jitter_hangs_on_ties(jitter_us, monkeypatch):
    """Why the config's cache service has 2 µs jitter."""
    prob = make_service("cache", 256, 3, np.random.default_rng(4), spacing_us=6000.0,
                        burst=6, jitter_us=jitter_us, dag_edges=chain_edges("cache", 3))
    prob["truth"] = create_cache_hits(prob["truth"], prob["in_parts"],
                                      prob["out_parts"], cache_rate=0.1)
    assert _perturbed_agreement(prob, monkeypatch) < 0.99


def _per_service(probs):
    out = []
    for p in probs:
        algo = tw.WeaverTorch({}, {}, device="cpu")
        out.append(algo.FindAssignments(
            "MaxScoreBatchSubsetWithSkips", p["service"], p["in_parts"],
            p["out_parts"], False, [], p["truth"], p["dag"]))
    return out


def test_solve_fleet_matches_per_service(port_fleet):
    """Padding and table indexing are invisible: the fleet reproduces the
    per-service solver (equal up to near ties, since padded blocks may
    sum in another order)."""
    probs, out, _, _ = port_fleet
    for p, f, s in zip(probs, out, _per_service(probs)):
        assert _agreement(f[0], s[0]) >= 0.99, p["service"]
        assert f[3] == s[3]
        assert abs(t_accuracy(f[0], p["truth"], p["in_parts"])
                   - t_accuracy(s[0], p["truth"], p["in_parts"])) <= 0.005


def test_budget_fallback_is_equivalent(port_fleet):
    probs, out, _, _ = port_fleet
    stats = {}
    fell_back = tf.solve_fleet(_items(probs), stats=stats, fleet_budget_elems=1,
                               device="cpu")
    assert stats["fleet_fallback_budget"] >= 1.0
    assert "fleet_dispatches" not in stats
    for p, f, s in zip(probs, out, fell_back):
        assert _agreement(f[0], s[0]) >= 0.99, p["service"]


def test_item_without_dag_falls_back():
    """No DAG: the per-service solver on the same device, and its result."""
    p = synth_fleet_8svc(32)[0]
    items = _items([p])
    items[0].dag = None
    stats, cells = {}, [0.0]
    nd = tf.solve_fleet(items, stats=stats, item_cells=cells, device="cpu")
    ref = tw.WeaverTorch({}, {}, device="cpu").FindAssignments(
        "MaxScoreBatchSubsetWithSkips", p["service"], p["in_parts"],
        p["out_parts"], False, [], p["truth"], None)
    assert stats.get("fleet_dispatches") is None and "solve_s" in stats
    assert len(nd) == 1 and len(nd[0]) == 6 and nd[0][3] == 32
    assert nd[0][0] == ref[0] and nd[0][2:] == ref[2:]
    assert cells[0] > 0


def test_solve_fleet_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.solve_fleet(_items(synth_fleet_8svc(8)[:1]))
    # bf16 is a precision of the port now; a misspelt one still raises
    with pytest.raises(ValueError):
        tf.solve_fleet(_items(synth_fleet_8svc(8)[:1]), device="cpu", precision="bf61")


# ---------------------------------------------------------------------------
# the solve supervisor
# ---------------------------------------------------------------------------

def _small_fleet():
    """Two services of one two-pass group (chain0, chain1 at 32 requests)."""
    return synth_fleet_8svc(32)[:2]


@pytest.fixture(scope="module")
def small_base():
    probs = _small_fleet()
    return tf.solve_fleet(_items(probs), device="cpu")


def test_injected_dispatch_fault_recovers_by_retry(small_base):
    stats = {}
    out = tf.solve_fleet(_items(_small_fleet()), stats=stats, device="cpu",
                         faults=tfaults.parse_faults("dispatch:1.0:max=1"),
                         retry_backoff_s=0.0)
    assert stats["faults_injected_dispatch"] == 1.0
    assert stats["fault_retries"] == 1.0 and stats["fault_recovered_retry"] == 1.0
    assert stats["fault_ladder"] == ["retry"]
    for o, b in zip(out, small_base):
        assert o[0] == b[0] and o[1] == b[1] and o[2:] == b[2:]


def test_persistent_faults_quarantine():
    probs = _small_fleet()
    stats, quarantined = {}, []
    out = tf.solve_fleet(_items(probs), stats=stats, quarantined=quarantined,
                         device="cpu", retry_backoff_s=0.0,
                         faults=tfaults.parse_faults("dispatch:1.0,host:1.0"))
    assert sorted(quarantined) == [0, 1]
    assert stats["fault_bisections"] == 1.0
    assert stats["fault_host_fallbacks"] == 2.0 and stats["fault_quarantined"] == 2.0
    assert stats["fault_ladder"][:3] == ["retry", "retry", "bisect"]
    assert stats["fault_ladder"].count("quarantine") == 2
    for p, o in zip(probs, out):
        ids = [s.GetId() for s in next(iter(p["in_parts"].values()))]
        assert len(o) == 6 and o[3] == o[5] == len(ids)
        assert all(o[0][ep][i] == NA for ep in o[0] for i in ids)


@pytest.mark.parametrize("err", [
    ValueError("a bug"),
    RuntimeError("fused_assign launch: CUDA error 700"),
    RuntimeError("a cluster of 16 CTAs of 512 threads with 200000 bytes of shared "
                 "memory each cannot be scheduled on this card"),
    RuntimeError("nvcc failed (1):\nerror"),
])
def test_non_transient_errors_propagate(monkeypatch, err):
    assert not tfaults.is_transient_fault(err)

    def broken(*a, **kw):
        raise err

    monkeypatch.setattr(tf, "solve_windows_fleet", broken)
    stats = {}
    with pytest.raises(type(err), match=re.escape(str(err))):
        tf.solve_fleet(_items(_small_fleet()), stats=stats, device="cpu")
    assert "fault_retries" not in stats


def test_cuda_oom_is_transient(monkeypatch, small_base):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert tfaults.is_transient_fault(oom)
    assert tfaults.is_transient_fault(RuntimeError("CUDA out of memory. Tried to "
                                                   "allocate 8.00 GiB"))
    assert tfaults.is_transient_fault(tfaults.FaultError("injected"))
    real, calls = tf.solve_windows_fleet, []

    def once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise oom
        return real(*a, **kw)

    monkeypatch.setattr(tf, "solve_windows_fleet", once)
    stats = {}
    out = tf.solve_fleet(_items(_small_fleet()), stats=stats, device="cpu",
                         retry_backoff_s=0.0)
    assert stats["fault_dispatch_errors"] == 1.0
    assert stats["fault_recovered_retry"] == 1.0
    for o, b in zip(out, small_base):
        assert o[0] == b[0]


def test_counters_exact_under_threads():
    """The fallback pool launches kernels and updates the ledger from
    several threads: neither the launch counters nor ``_Stats`` may lose
    an increment."""
    import sys
    import threading

    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    st, n_threads, n_each = tf._Stats({}), 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        K.reset_launches()

        def work():
            for _ in range(n_each):
                K._count_launch("fused_assign")
                st.add("k")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert K.LAUNCHES["fused_assign"] == n_threads * n_each
        assert st.d["k"] == n_threads * n_each
    finally:
        sys.setswitchinterval(interval)
        K.reset_launches()


def test_parse_faults_rejects_bad_specs():
    assert tfaults.parse_faults("") is None
    plan = tfaults.parse_faults("fetch:0.5:max=2", seed=3)
    assert plan.sites["fetch"].max == 2 and plan.seed == 3
    for bad in ("dispatch", "migrate:0.1", "dispatch:2", "dispatch:0.1:min=1",
                "host:0.1,host:0.2"):
        with pytest.raises(ValueError):
            tfaults.parse_faults(bad)
