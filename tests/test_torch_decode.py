"""The port's integer-code decode (``weaver_torch.decode_service``) against
the JAX package's ``WeaverTPU._decode`` + ``_resolve_cross_window_duplicates``
on seeded packed outputs (CPU, no solve):

- assignment dicts and top-K lists equal, key order included, and
  ``not_best_count``, ``per_span_candidates`` and ``cnt_unassigned``;
- one case per mapping rule and per branch of the contested walk, and a
  service decoded from several packed chunks out of time order, with
  shared and with separate id tables;
- the resolve cases of ``tests/test_solver.py`` through the new function;
- ``decode_answers`` / ``decode_contested`` in one CPU fleet round.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from traceweaver_tpu.algorithms import weaver_tpu as jw

from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.metrics.synth import synth_fleet_8svc
from traceweaver_tpu_torch.spans import NA, SKIP

torch.set_num_threads(1)


def _ids(prefix, n):
    out = np.empty(n, dtype=object)
    out[:] = [("t", f"{prefix}{k}") for k in range(n)]
    return out


class Service:
    """One service's packed chunks: windows tiling ``[0, n_in)``, E
    endpoints with ``[B]`` candidate ranges into their tables, and the
    device's answer channels, ``[B, E, W]`` and ``[B, E, W, K]``."""

    def __init__(self, rng, n_in=48, E=2, W=8, M=8, K=4, stride=4):
        self.rng = rng
        self.M, self.K, self.E, self.W = M, K, E, W
        self.windows = [(lo, min(lo + W, n_in)) for lo in range(0, n_in, W)]
        B = len(self.windows)
        self.in_ids = _ids("i", n_in)
        self.out_eps = [f"svc:ep{e}" for e in range(E)]
        # window b's columns start at b * stride: with stride < M the
        # ranges of neighbouring windows overlap, as capped sub-windows do
        self.r0 = np.tile((np.arange(B) * stride)[:, None], (1, E))
        self.count = np.full((B, E), M)
        self.tables = [_ids(f"o{e}_", B * stride + M) for e in range(E)]
        self.assign = rng.integers(0, M, size=(B, E, W)).astype(np.int32)
        self.topk = rng.integers(-1, M, size=(B, E, W, K)).astype(np.int32)
        self.not_best = rng.random((B, E, W)) < 0.2
        self.feas = rng.integers(0, 5, size=(B, E, W)).astype(np.int32)
        self.skip_budget = {ep: 0 for ep in self.out_eps}

    def chunks(self, order=None, own_tables=False):
        """``[(rows of windows, tables)]``: the windows in ``order`` groups
        (FindAssignments' size-class chunks), each its own packed batch."""
        order = order or [list(range(len(self.windows)))]
        out = []
        for k, rows in enumerate(order):
            tables = ([t.copy() for t in self.tables] if own_tables and k
                      else self.tables)
            out.append((rows, tables))
        return out

    def packed(self, mod, rows, tables):
        B = len(rows)
        out_ids = [mod.EndpointIds(tables[e], self.r0[rows, e].astype(np.int64),
                                   self.count[rows, e].astype(np.int64), self.M)
                   for e in range(self.E)]
        return mod.PackedProblem(
            arrays={"out_start": np.zeros((B, self.E, self.M), np.float32)},
            out_eps=self.out_eps, windows=[self.windows[b] for b in rows],
            in_ids=self.in_ids, out_ids=out_ids, n_in=len(self.in_ids))

    def outputs(self, rows):
        return (self.assign[rows], self.topk[rows], self.not_best[rows], self.feas[rows])


def _jax_decode(svc: Service, chunks):
    """The JAX package's per-service decode, resolve and tallies."""
    in_ids = svc.in_ids.tolist()
    n_in = len(in_ids)
    aa = {ep: {} for ep in svc.out_eps}
    at = {ep: {} for ep in svc.out_eps}
    nb = np.zeros(n_in, dtype=bool)
    cands = np.ones(n_in, dtype=np.int64)
    for rows, tables in chunks:
        packed = svc.packed(jw, rows, tables)
        assign, topk, not_best, feas = svc.outputs(rows)
        jw.WeaverTPU._decode(packed, assign, topk, aa, at)
        jw.scatter_window_span_stats(packed.windows, not_best, feas, nb, cands)
    jw.WeaverTPU._resolve_cross_window_duplicates(aa, at, in_ids, svc.skip_budget)
    unassigned = sum(1 for i in in_ids if any(aa[ep][i] == NA for ep in svc.out_eps))
    return (aa, at, int(nb.sum()), n_in, {in_ids[j]: int(cands[j]) for j in range(n_in)},
            unassigned)


def _port_decode(svc: Service, chunks):
    batches = [(svc.packed(tw, rows, tables), *svc.outputs(rows)) for rows, tables in chunks]
    return tw.decode_service(batches, svc.out_eps, svc.in_ids.tolist(), svc.skip_budget)


def _claims_after_first(svc: Service, chunks) -> int:
    """Answers whose out-span an earlier answer (in span order) claimed,
    from the JAX package's decode before its resolve."""
    aa = {ep: {} for ep in svc.out_eps}
    at = {ep: {} for ep in svc.out_eps}
    for rows, tables in chunks:
        jw.WeaverTPU._decode(svc.packed(jw, rows, tables), *svc.outputs(rows)[:2], aa, at)
    n = 0
    for amap in aa.values():
        real = Counter(v for v in amap.values() if v not in (NA, SKIP))
        n += sum(c - 1 for c in real.values())
    return n


def _disjoint(svc: Service):
    """Every window its own columns and each row its own column: no contest."""
    svc.r0 = np.tile((np.arange(len(svc.windows)) * svc.M)[:, None], (1, svc.E))
    svc.tables = [_ids(f"o{e}_", len(svc.windows) * svc.M) for e in range(svc.E)]
    for b in range(len(svc.windows)):
        for e in range(svc.E):
            svc.assign[b, e] = svc.rng.permutation(svc.M)[:svc.W]


def _contested_rows(svc: Service):
    """A contest in every window pair: window b's row 0 and window
    b + 1's row 0 claim the same out-span (column stride and 0)."""
    stride = svc.r0[1, 0] - svc.r0[0, 0]
    svc.assign[:, :, 0] = 0
    svc.assign[:-1, :, 0] = stride
    return stride


def case_no_contest(svc):
    _disjoint(svc)


def case_free_alternative(svc):
    _contested_rows(svc)
    # each loser's top-K: its own choice, then a column no one takes
    svc.topk[:, :, 0, :] = -1
    svc.topk[:, :, 0, 0] = 0
    svc.topk[:, :, 0, 1] = svc.M - 1


def case_skip_room(svc):
    _contested_rows(svc)
    svc.topk[:, :, 0, :] = -1
    svc.topk[:, :, 0, 1] = svc.M          # SKIP second
    svc.topk[:, :, 0, 2] = svc.M - 1
    svc.skip_budget = {ep: 3 for ep in svc.out_eps}


def case_skip_spent(svc):
    case_skip_room(svc)
    svc.topk[:, :, 0, 2] = 0              # the contested span again: held
    svc.assign[-1, :, 1] = svc.M          # a decoded SKIP uses the budget
    svc.skip_budget = {ep: 1 for ep in svc.out_eps}


def case_empty_and_negative(svc):
    svc.count[1::2] = svc.M // 2          # upper half of the slots empty
    svc.assign[:, :, ::3] = -1
    svc.topk[:, :, 1::2, 0] = -3


def case_skip_and_past_m(svc):
    svc.assign[:, :, ::4] = svc.M         # SKIP
    svc.assign[:, :, 1::4] = svc.M + 3    # past M: read as column M - 1
    svc.count[::3] = svc.M - 2            # ... which is empty in some windows
    svc.topk[:, :, ::2, 1] = svc.M
    svc.topk[:, :, 1::2, 2] = svc.M + 1   # a top-K column past M: NA
    svc.skip_budget = {ep: 5 for ep in svc.out_eps}


def case_chosen_in_topk(svc):
    # rows 0-2: the choice absent from its top-K; rows 3-5: present twice
    svc.topk[:, :, :3, :] = np.where(svc.topk[:, :, :3, :] == svc.assign[:, :, :3, None],
                                     -1, svc.topk[:, :, :3, :])
    svc.topk[:, :, 3:6, 1] = svc.assign[:, :, 3:6]
    svc.topk[:, :, 3:6, 3] = svc.assign[:, :, 3:6]


CASES = {
    "no_contest": case_no_contest,
    "free_alternative": case_free_alternative,
    "skip_room": case_skip_room,
    "skip_spent": case_skip_spent,
    "empty_and_negative": case_empty_and_negative,
    "skip_and_past_m": case_skip_and_past_m,
    "chosen_in_topk": case_chosen_in_topk,
    "random": lambda svc: None,
}


def _check(svc, chunks):
    want = _jax_decode(svc, chunks)
    got, counts = _port_decode(svc, chunks)
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert list(g) == list(w)
        for ep in w:
            assert list(g[ep].items()) == list(w[ep].items()), ep
    n_answers = sum(hi - lo for lo, hi in svc.windows) * svc.E
    assert counts == {"decode_answers": float(n_answers),
                      "decode_contested": float(_claims_after_first(svc, chunks))}
    return got, counts


@pytest.mark.parametrize("seed", [3, 4100000017])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(case, seed):
    svc = Service(np.random.default_rng(seed))
    CASES[case](svc)
    got, counts = _check(svc, svc.chunks())
    assigned = [v for amap in got[0].values() for v in amap.values()]
    if case == "no_contest":
        assert counts["decode_contested"] == 0
    else:
        assert counts["decode_contested"] > 0
    if case == "skip_room":
        assert SKIP in assigned
    if case in ("skip_spent", "empty_and_negative"):
        assert got[5] > 0 and NA in assigned
    if case == "skip_and_past_m":
        assert SKIP in assigned and NA in assigned


@pytest.mark.parametrize("own_tables", [False, True])
@pytest.mark.parametrize("case", ["free_alternative", "skip_spent", "random"])
def test_decode_chunks_out_of_time_order(case, own_tables):
    """A service decoded from several packed chunks, later windows first,
    as ``FindAssignments`` decodes its size-class chunks; each chunk past
    the first with its own copy of the id tables when ``own_tables``."""
    svc = Service(np.random.default_rng(7), n_in=64)
    CASES[case](svc)
    order = [[5, 1, 7], [0, 2], [3, 4, 6]]
    _check(svc, svc.chunks(order, own_tables=own_tables))


def _resolve(assignments, topk, in_ids, budget):
    """``decode_service`` on one endpoint's answers given as span ids:
    each incoming span its own window, decoded in ``assignments``' order,
    its columns the endpoint's table in the order the answers name them."""
    ep = next(iter(assignments))
    amap, tmap = assignments[ep], topk[ep]
    table_ids = list(dict.fromkeys(
        v for k in amap for v in [amap[k], *tmap[k]] if v not in (NA, SKIP)))
    table = np.empty(len(table_ids), dtype=object)
    table[:] = table_ids
    col = {sid: j for j, sid in enumerate(table_ids)}
    M, K = len(table_ids), max(len(v) for v in tmap.values())
    in_arr = np.empty(len(in_ids), dtype=object)
    in_arr[:] = in_ids
    batches = []
    for in_id in amap:
        b = in_ids.index(in_id)
        ids = tw.EndpointIds(table, np.zeros(1, np.int64), np.full(1, M, np.int64), M)
        packed = tw.PackedProblem(arrays={"out_start": np.zeros((1, 1, M), np.float32)},
                                  out_eps=[ep], windows=[(b, b + 1)], in_ids=in_arr,
                                  out_ids=[ids], n_in=len(in_ids))
        code = {SKIP: M, NA: -1, **col}
        row = [code[v] for v in tmap[in_id]] + [-1] * (K - len(tmap[in_id]))
        batches.append((packed, np.array([[[code[amap[in_id]]]]], np.int32),
                        np.array([[[row]]], np.int32), np.zeros((1, 1, 1), bool),
                        np.ones((1, 1, 1), np.int32)))
    got, counts = tw.decode_service(batches, [ep], in_ids, {ep: budget})
    return got[0][ep], counts["decode_contested"]


def test_cross_window_duplicate_resolution_semantics():
    """``tests/test_solver.py``'s resolve cases through the port: the
    earliest span in time keeps a contested span though decoded last; a
    loser's fallback cannot displace another row's commitment; SKIP
    fallbacks respect the endpoint's budget."""
    ep = "svc:op"
    o1, o2, o3 = ("t", "o1"), ("t", "o2"), ("t", "o3")
    A, B, C = ("t", "a"), ("t", "b"), ("t", "c")
    got, contested = _resolve({ep: {C: o1, A: o1, B: o2}},
                              {ep: {C: [o1, o2, o3], A: [o1], B: [o2]}}, [A, B, C], 0)
    assert (got[A], got[B], got[C]) == (o1, o2, o3)
    assert contested == 1

    got, _ = _resolve({ep: {A: o1, B: o1}}, {ep: {A: [o1], B: [o1, SKIP]}}, [A, B], 0)
    assert got[B] == NA
    got, _ = _resolve({ep: {A: o1, B: o1}}, {ep: {A: [o1], B: [o1, SKIP]}}, [A, B], 1)
    assert got[B] == SKIP


def test_fleet_round_decode_counters(monkeypatch):
    """One CPU fleet round with capped sub-windows: ``decode_answers`` is
    every (incoming span, endpoint) answer, ``decode_contested`` the
    answers whose out-span an earlier span claimed before resolution
    (counted from the JAX package's decode of the same device answers)."""
    probs = synth_fleet_8svc(32)[:2]
    claims = []
    real = tw.WeaverTorch._decode

    def spy(packed, assign, topk_cols, codes, topk_codes):
        aa = {ep: {} for ep in packed.out_eps}
        at = {ep: {} for ep in packed.out_eps}
        jw.WeaverTPU._decode(packed, assign, topk_cols, aa, at)
        for amap in aa.values():
            real_ids = Counter(v for v in amap.values() if v not in (NA, SKIP))
            claims.append(sum(c - 1 for c in real_ids.values()))
        return real(packed, assign, topk_cols, codes, topk_codes)

    monkeypatch.setattr(tw.WeaverTorch, "_decode", staticmethod(spy))
    stats = {}
    items = [tf.FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                          p["dag"]) for p in probs]
    out = tf.solve_fleet(items, stats=stats, max_window=4, device="cpu")
    answers = sum(len(next(iter(p["in_parts"].values()))) * len(p["out_parts"])
                  for p in probs)
    assert stats["decode_answers"] == float(answers)
    assert stats["decode_contested"] == float(sum(claims)) > 0
    for amap, *_ in out:
        for ep, answers_ep in amap.items():
            real_ids = [v for v in answers_ep.values() if v not in (NA, SKIP)]
            assert len(real_ids) == len(set(real_ids)), ep
