"""Device-resident span columns of the port against the host packer and
the JAX package (``traceweaver_tpu_torch/ops/devcols.py``).

- ``assemble_windows`` gathers the six window tensors byte-identical to
  the port's host packer and to the JAX package's ``assemble_windows``
  on the same ring contents and index arrays, over seeds, endpoint
  counts and dropped rows;
- ``solve_fleet`` with ``devcols`` on and off gives identical results,
  pipelined and serial, compacted and not, at f32 and bf16, and with
  forced skips;
- the byte ledger splits resident from shipped, and a second solve
  ships no column bytes;
- non-integral timestamps and oversized partitions pack on the host,
  counted; eviction, id collisions and ``rebuild``;
- the ``devcols`` fault site at resolve and at gather takes the
  ring-rebuild rung and gives an identical result.

All on the CPU, where the rings are CPU tensors and the same code runs.
"""

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.algorithms.fleet import FleetItem, solve_fleet
from traceweaver_tpu_torch.dag import DAG
from traceweaver_tpu_torch.ops import devcols
from traceweaver_tpu_torch.runtime import faults
from traceweaver_tpu_torch.spans import SKIP, Span, SpanArray


@pytest.fixture(autouse=True)
def _fresh_rings():
    devcols.get_store().clear()
    yield
    devcols.get_store().clear()


def _random_problem(seed=0, n_traces=50, eps=("A", "B"), burst=6, drop_every=0,
                    integral=True):
    """One service's partitions with integral-µs times (fractional with
    ``integral=False``), every ``drop_every``-th call skipped."""
    rng = np.random.default_rng(seed)
    in_spans, out_spans = [], {ep: [] for ep in eps}
    ta = {ep: {} for ep in eps}
    t = 0.0
    frac = 0.0 if integral else 0.25
    for i in range(n_traces):
        t += float(rng.integers(20, 60)) if i % burst else 4000.0
        s_in = Span(f"t{i}", "in", t + frac, 350.0 + 30.0 * len(eps), "op", [], "svc",
                    "server")
        in_spans.append(s_in)
        dropped = drop_every and i % drop_every == 0
        prev = t + 8.0
        for ep in eps:
            if dropped:
                ta[ep][s_in.GetId()] = SKIP
                continue
            start = prev + 12.0 + float(rng.integers(0, 6))
            s_out = Span(f"t{i}", f"out-{ep}", start + frac, 40.0, f"op{ep}", [], "svc",
                         "client")
            out_spans[ep].append(s_out)
            ta[ep][s_in.GetId()] = s_out.GetId()
            prev = start + 40.0
    dag = DAG()
    for ep in eps:
        dag.add_node(ep)
    for a, b in zip(eps, eps[1:]):
        dag.add_edge(a, b)
    in_spans.sort(key=lambda s: (s.start_mus, s.end_mus))
    for part in out_spans.values():
        part.sort(key=lambda s: (s.start_mus, s.end_mus))
    return in_spans, out_spans, list(eps), ta, dag


def _items(n_services=2, method="MaxScoreBatchSubsetWithSkips", drop_every=0,
           integral=True, seed0=0, tenant=None):
    items = []
    for k in range(n_services):
        i, o, _, ta, dag = _random_problem(
            seed=seed0 + k, eps=("A", "B") if k % 2 == 0 else ("A",),
            drop_every=drop_every, integral=integral)
        items.append(FleetItem(f"svc{k}", {"IN": i}, o, ta, dag, method=method,
                               tenant=tenant))
    return items


def _solve(devcols_on, items, **kw):
    devcols.get_store().clear()
    stats = {}
    res = solve_fleet(items, stats=stats, device="cpu", devcols=devcols_on,
                      retry_backoff_s=0.0, **kw)
    return [tuple(r) for r in res], stats


@pytest.mark.parametrize("seed,eps,drop", [
    (0, ("A", "B"), 0), (1, ("A", "B", "C"), 0), (2, ("A",), 0), (3, ("A", "B"), 5)])
def test_assembled_tensors_byte_identical(seed, eps, drop):
    import jax.numpy as jnp

    from traceweaver_tpu.ops import devcols as jdevcols

    in_spans, out_parts, out_eps, ta, dag = _random_problem(seed=seed, eps=eps,
                                                            drop_every=drop)
    plan = tw.plan_find_assignments({"IN": in_spans}, out_parts, out_eps, dag, ta)
    host = tw.pack_problem(in_spans, out_parts, out_eps, plan["dists"], "IN", dag,
                           force_skip_ids=plan["force_skip_ids"])
    in_cols = tw.in_columns(in_spans)
    out_cols = tw.out_columns(out_parts, out_eps)
    store = devcols.get_store()
    ring_in = store.ring(None, "svc", "in")
    ring_out = store.ring(None, "svc", "out")
    in_slots = ring_in.resolve(in_cols)[0]
    out_slots = {ep: ring_out.resolve(out_cols[ep], endpoint=ep)[0] for ep in out_eps}
    dc = tw._pack_problem_devcols(in_spans, out_parts, out_eps, plan["dists"], "IN",
                                  dag, in_slots, out_slots, ring_in, ring_out,
                                  force_skip_ids=plan["force_skip_ids"])
    assert dc.windows == host.windows and dc.M == host.arrays["out_start"].shape[2]
    b = dc.devcols
    idx = [torch.as_tensor(b[k]) for k in ("in_idx", "out_idx", "origin_in",
                                           "origin_out")]
    outs = devcols.assemble_windows(ring_in.buf, ring_out.buf, *idx)
    jouts = jdevcols.assemble_windows(
        jnp.asarray(ring_in.buf.numpy()), jnp.asarray(ring_out.buf.numpy()),
        *(jnp.asarray(b[k]) for k in ("in_idx", "out_idx", "origin_in", "origin_out")))
    names = ("in_start", "in_end", "in_valid", "out_start", "out_end", "out_valid")
    for name, got, jgot in zip(names, outs, jouts):
        got = devcols.fetch_resident(got)
        want = host.arrays[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), f"{name}: not the host packer's"
        assert got.tobytes() == np.asarray(jgot).tobytes(), f"{name}: not JAX's"
    for name in ("skip_cap", "force_skip"):
        assert dc.arrays[name].tobytes() == host.arrays[name].tobytes()
    for e in range(len(out_eps)):
        a, c = host.out_id_array(e), dc.out_id_array(e)
        assert a.shape == c.shape and all(x == y for x, y in zip(a, c))


@pytest.mark.parametrize("pipeline,compaction", [
    (False, False), (False, True), (True, False), (True, True)])
def test_solve_fleet_parity_flow_matrix(pipeline, compaction):
    host, _ = _solve(False, _items(3), pipeline=pipeline, compaction=compaction)
    dev, st = _solve(True, _items(3), pipeline=pipeline, compaction=compaction)
    assert st.get("h2d_bytes_ring", 0) > 0 and not st.get("devcols_fallbacks")
    assert host == dev


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_solve_fleet_parity_precisions(precision):
    host, _ = _solve(False, _items(2), precision=precision)
    dev, st = _solve(True, _items(2), precision=precision)
    assert st.get("h2d_bytes_ring", 0) > 0
    assert host == dev


def test_solve_fleet_parity_forced_skips():
    kw = dict(method="MaxScoreBatchSubsetWithTrueSkips", drop_every=4)
    host, _ = _solve(False, _items(2, **kw))
    dev, st = _solve(True, _items(2, **kw))
    assert st.get("h2d_bytes_ring", 0) > 0
    assert host == dev


def test_h2d_ledger_splits_resident_vs_shipped():
    _, s0 = _solve(False, _items(2))
    _, s1 = _solve(True, _items(2))
    assert s0.get("h2d_bytes_shipped", 0) > 0
    assert not s0.get("h2d_bytes_ring") and not s0.get("h2d_bytes_index")
    assert s1.get("h2d_bytes_ring", 0) > 0 and s1.get("h2d_bytes_index", 0) > 0
    assert s1["h2d_bytes_shipped"] < s0["h2d_bytes_shipped"]


def test_second_solve_ships_zero_column_bytes():
    s1, s2 = {}, {}
    solve_fleet(_items(2), stats=s1, device="cpu")
    solve_fleet(_items(2), stats=s2, device="cpu")
    assert s1.get("h2d_bytes_ring", 0) > 0
    assert s2.get("h2d_bytes_ring", 0) == 0, "resident spans shipped again"
    assert s2.get("h2d_bytes_index", 0) > 0


def test_tenants_and_services_keep_rings_of_their_own():
    """A ring per (tenant, service, partition): two tenants posting the
    same span ids never evict each other, and each span's columns cross
    once."""
    solve_fleet(_items(2, tenant="a"), stats={}, device="cpu")
    solve_fleet(_items(2, tenant="b"), stats={}, device="cpu")
    rings = devcols.get_store().rings()
    assert len(rings) == 8
    before = sum(r.appended_rows for r in rings)
    st = {}
    solve_fleet(_items(2, tenant="a") + _items(2, tenant="b"), stats=st, device="cpu")
    assert sum(r.appended_rows for r in devcols.get_store().rings()) == before
    assert st["tenant_windows_packed"] == st["tenant_windows_decoded"]


def test_fractional_timestamps_fall_back_counted():
    host, _ = _solve(False, _items(2, integral=False))
    dev, st = _solve(True, _items(2, integral=False))
    assert st.get("devcols_fallbacks", 0) > 0 and not st.get("h2d_bytes_ring")
    assert host == dev


def test_oversized_partition_falls_back():
    host, _ = _solve(False, _items(1, seed0=7))
    dev, st = _solve(True, _items(1, seed0=7), ring_capacity=16)
    assert st.get("devcols_fallbacks", 0) > 0
    assert host == dev
    ring = devcols.ColumnRing("test", cap=16)
    in_spans, *_ = _random_problem(seed=9, n_traces=40)
    assert ring.resolve(tw.in_columns(in_spans)) is None


def _cols(times):
    return SpanArray.from_spans([Span(f"r{i}", "s", float(t), 10.0, "op", [], "p",
                                      "server") for i, t in enumerate(times)])


def test_ring_eviction_and_reappend():
    ring = devcols.ColumnRing("t", cap=8)
    a = _cols([100, 200, 300, 400])
    s1, _ = ring.resolve(a)
    assert len(set(s1.tolist())) == 4
    ring.resolve(_cols([500, 600, 700, 800]))
    ring.resolve(_cols([900, 1000, 1100, 1200]))
    before = ring.appended_rows
    s2, seq = ring.resolve(a)
    assert ring.appended_rows == before + 4 and seq == before
    got = devcols.fetch_resident(ring.buf)
    np.testing.assert_array_equal(got[s2, 0] + ring.epoch, a.start)


def test_stale_gather_packs_on_the_host_counted():
    """A group whose slots another resolve evicted before its gather
    packs on the host (counted) and solves alike."""
    items = _items(1)
    host, _ = _solve(False, items)
    devcols.get_store().clear()
    stats = {}
    real = devcols.assemble_resident

    def evict_first(ring_in, ring_out, *args, **kw):
        ring_in.evict_seq = ring_in.next_seq  # everything resident dies
        return real(ring_in, ring_out, *args, **kw)

    devcols.assemble_resident = evict_first
    try:
        dev = [tuple(r) for r in solve_fleet(_items(1), stats=stats, device="cpu")]
    finally:
        devcols.assemble_resident = real
    assert stats.get("devcols_fallbacks", 0) == 1
    assert dev == host


def test_ring_id_collision_reappends():
    ring = devcols.ColumnRing("t", cap=64)
    ring.resolve(_cols([100, 200, 300]))
    b = _cols([1100, 1200, 1300])   # the same ids, other times
    slots, _ = ring.resolve(b)
    got = devcols.fetch_resident(ring.buf)
    np.testing.assert_array_equal(got[slots, 0] + ring.epoch, b.start)


def test_resident_resolve_is_free():
    ring = devcols.ColumnRing("t", cap=64)
    a = _cols([100, 200, 300, 400, 500])
    ring.resolve(a)
    rows, nbytes = ring.appended_rows, ring.appended_bytes
    assert ring.resolve(a) is not None
    assert (ring.appended_rows, ring.appended_bytes) == (rows, nbytes)


def test_ring_rebuild_preserves_live_slots_bit_identical():
    ring = devcols.ColumnRing("t", cap=64)
    a = _cols([100, 200, 300, 400, 500])
    slots, _ = ring.resolve(a, endpoint="EP0")
    before = devcols.fetch_resident(ring.buf)
    shipped = ring.rebuild()
    after = devcols.fetch_resident(ring.buf)
    assert shipped == after.nbytes and ring.rebuilds == 1
    np.testing.assert_array_equal(before[slots], after[slots])
    rows = ring.appended_rows
    np.testing.assert_array_equal(ring.resolve(a, endpoint="EP0")[0], slots)
    assert ring.appended_rows == rows


def test_devcols_fault_at_resolve_rebuilds_and_solves_identical():
    clean, _ = _solve(True, _items(2))
    out, stats = _solve(True, _items(2), faults=faults.parse_faults("devcols:1.0:max=1"))
    assert out == clean
    assert stats.get("devcols_ring_rebuilds", 0) >= 2
    assert "ring-rebuild" in stats.get("fault_ladder", [])
    assert stats.get("faults_injected_devcols", 0) == 1


def test_devcols_fault_at_gather_enters_ladder_with_rebuild():
    clean, _ = _solve(True, _items(2))
    out, stats = _solve(True, _items(2), pipeline=False,
                        faults=faults.parse_faults("devcols:1.0:max=3"))
    assert out == clean
    assert stats.get("faults_injected_devcols", 0) == 3
    assert stats.get("fault_retries", 0) >= 1
    assert stats.get("fault_ladder", []).count("ring-rebuild") >= 2


@pytest.mark.gpu
def test_appends_racing_gathers_on_another_stream_match_serial():
    """Appends from one thread against gathers on another stream of
    another thread, on a ring small enough to wrap: every gather the
    ring let through (its slots still live) equals the same window's
    columns computed on the host, and at least most went through."""
    import queue
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    ring_in = devcols.ColumnRing("in", cap=1 << 10, device=dev)
    ring_out = devcols.ColumnRing("out", cap=1 << 10, device=dev)
    rng = np.random.default_rng(0)
    batches, t = [], 1000.0
    for k in range(256):
        times = t + np.sort(rng.integers(0, 5000, 96)).astype(float)
        t += 6000.0
        batches.append(SpanArray.from_spans([
            Span(f"b{k}", f"s{i}", float(x), 30.0 + i, "op", [], "p", "server")
            for i, x in enumerate(times)]))
    todo, got = queue.Queue(maxsize=4), []

    def producer():
        for cols in batches:
            slots, seq = ring_in.resolve(cols)
            todo.put((slots, seq, cols))
        todo.put(None)

    def consumer():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            while (job := todo.get()) is not None:
                slots, seq, cols = job
                origin = ring_in.rel32(cols.start[:1])
                out = devcols.assemble_resident(
                    ring_in, ring_out, slots[None, :], np.full((1, 1, 1), -1, np.int32),
                    origin, origin, live=(seq, 0))
                got.append((cols, None if out is None else (out[0], out[1])))
        stream.synchronize()

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    checked = 0
    for cols, out in got:
        if out is None:
            continue
        want_start = (cols.start - cols.start[0]).astype(np.float32)[None, :]
        want_end = (cols.end - cols.start[0]).astype(np.float32)[None, :]
        assert out[0].cpu().numpy().tobytes() == want_start.tobytes()
        assert out[1].cpu().numpy().tobytes() == want_end.tobytes()
        checked += 1
    assert checked >= len(batches) // 2
