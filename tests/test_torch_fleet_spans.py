"""The fleet round's stage scopes (CPU, pipelined, ``device="cpu"``).

- under ``profiling()`` a round holds a ``tw:fleet:*`` range on every
  host stage, each group's pack, dispatch, fetch and decode carrying the
  group's index as their one argument; with profiling off there is no
  ``tw:*`` range;
- the ranges and the stats come from one pair of stamps: the ranges'
  summed durations equal ``pack_s``, ``decode_s`` and ``plan_fit_s``;
- the round's ``fleet_lead_s``, ``fleet_tail_s`` and ``decode_wall_s``
  fit inside the round and its ranges, and a round that launched no
  group writes none of them;
- a full garbage collection under profiling is a ``tw:gc:2`` range, and
  the hook goes when profiling does;
- a keyed round's self-trace holds the same stage names as before;
- the scope's stamps and bills lose nothing under many threads.
"""

import gc
import sys
import threading
import time
from collections import defaultdict

import pytest
import torch
from test_torch_obs import _fleet_items

from traceweaver_tpu_torch.algorithms.fleet import FleetItem, _Stats, solve_fleet
from traceweaver_tpu_torch.algorithms.plancache import PlanCache
from traceweaver_tpu_torch.obs import profile as t_profile
from traceweaver_tpu_torch.obs import selftrace as t_selftrace

torch.set_num_threads(1)

#: every host stage of a round with a cold plan cache (two-pass groups
#: admit their refits)
HOST_STAGES = ("plan", "window-plan", "group", "pack", "dispatch", "fetch",
               "decode", "plan-admit")


def _trace():
    """A CPU trace of every thread that records the ranges' arguments."""
    from torch.profiler import ProfilerActivity, profile

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                   experimental_config=config)


def _ranges(prof):
    """``{name: [(seconds, args)]}`` of the trace's ``tw:*`` ranges."""
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("tw:"):
            out[e.name()].append((e.duration_ns() * 1e-9, list(e.concrete_inputs())))
    return out


def _round(**kw):
    """One pipelined CPU round over three services split into three
    groups (``merge_budget=0``), a cold plan cache, its stats and wall."""
    stats = {}
    t0 = time.perf_counter()
    solve_fleet(_fleet_items(), device="cpu", pipeline=True, stats=stats,
                merge_budget=0, plan_cache=PlanCache(), **kw)
    return stats, time.perf_counter() - t0


@pytest.fixture(scope="module")
def traced():
    with t_profile.profiling(), _trace() as prof:
        stats, wall = _round()
    return _ranges(prof), stats, wall


def _dur(ranges, stage):
    return sum(d for d, _ in ranges.get("tw:fleet:" + stage, []))


def test_round_holds_every_host_stage(traced):
    ranges, stats, _ = traced
    assert stats["pipeline_groups"] == 3
    assert {"tw:fleet:" + s for s in HOST_STAGES} <= set(ranges)
    # nested in the dispatch, as before
    assert {"tw:fleet:warm-dispatch", "tw:fleet:flag-fetch"} <= set(ranges)
    # one plan, window plan and grouping a round, none with a group
    for stage in ("plan", "window-plan", "group"):
        assert [a for _, a in ranges["tw:fleet:" + stage]] == [[]]


@pytest.mark.parametrize("stage", ["pack", "dispatch", "decode"])
def test_each_group_stage_once_with_its_group(traced, stage):
    ranges, stats, _ = traced
    args = [a for _, a in ranges["tw:fleet:" + stage]]
    assert all(len(a) == 1 and isinstance(a[0], int) for a in args)
    assert sorted(a[0] for a in args) == list(range(int(stats["pipeline_groups"])))


def test_fetches_carry_their_group(traced):
    ranges, stats, _ = traced
    groups = [a for _, a in ranges["tw:fleet:fetch"]]
    assert groups and all(len(a) == 1 for a in groups)
    assert {a[0] for a in groups} == set(range(int(stats["pipeline_groups"])))


def test_no_ranges_with_profiling_off():
    with _trace() as prof:
        _round()
        gc.collect()
    assert not _ranges(prof)


@pytest.mark.parametrize("stages,key", [
    (("pack", "window-plan"), "pack_s"),
    (("decode",), "decode_s"),
    (("plan", "plan-admit"), "plan_fit_s"),
])
def test_ranges_and_stats_share_one_stamp(traced, stages, key):
    ranges, stats, _ = traced
    got = sum(_dur(ranges, s) for s in stages)
    assert got == pytest.approx(stats[key], rel=0.02, abs=1e-3)


def test_round_structure(traced):
    ranges, stats, wall = traced
    lead, tail = stats["fleet_lead_s"], stats["fleet_tail_s"]
    assert 0.0 < lead and 0.0 < tail and lead + tail <= wall
    assert lead >= _dur(ranges, "plan")
    longest = max(d for d, _ in ranges["tw:fleet:decode"])
    assert longest - 1e-3 <= stats["decode_wall_s"] <= stats["decode_s"] + 1e-9


def test_round_structure_untraced():
    stats, wall = _round()
    assert 0.0 < stats["fleet_lead_s"] and 0.0 < stats["fleet_tail_s"]
    assert stats["fleet_lead_s"] + stats["fleet_tail_s"] <= wall
    assert 0.0 < stats["decode_wall_s"] <= stats["decode_s"] + 1e-9


def test_no_round_structure_without_a_group():
    """Items the fused dispatch cannot carry (no DAG) solve per service:
    the round launched no group."""
    items = [FleetItem(it.svc, it.in_span_partitions, it.out_span_partitions,
                       it.true_assignments) for it in _fleet_items(24)[:1]]
    stats = {}
    solve_fleet(items, device="cpu", stats=stats)
    assert stats["plan_fit_s"] > 0.0
    assert not {"fleet_lead_s", "fleet_tail_s", "decode_wall_s"} & set(stats)


def test_gc_collection_is_a_range():
    with _trace() as prof:
        with t_profile.profiling():
            assert t_profile._gc_range in gc.callbacks
            gc.collect()
        assert t_profile._gc_range not in gc.callbacks
        gc.collect()
    ranges = _ranges(prof)
    assert len(ranges["tw:gc:2"]) == 1
    assert "tw:gc:0" not in ranges


def test_selftrace_stage_names_unchanged():
    """A keyed round stamps pack, dispatch and decode on each window trace,
    compact-fetch on those of compacted groups (more than one window) and
    redispatch where windows were redispatched, under the stage names of
    before the stage scope; nothing more."""
    items = _fleet_items()
    for k, it in enumerate(items):
        it.trace_key = f"w{k}"
    tr = t_selftrace.PipelineTracer()
    prev = t_selftrace.install(tr)
    stats = {}
    try:
        solve_fleet(items, device="cpu", pipeline=True, stats=stats, merge_budget=0)
    finally:
        t_selftrace.install(prev)
    traces = tr.payload()["data"]
    assert len(traces) == len(items)
    seen = set()
    for t in traces:
        ops = {s["operationName"] for s in t["spans"]
               if not s["operationName"].startswith("call-")} - {t_selftrace.ROOT_OP}
        assert {"pack", "dispatch", "decode"} <= ops
        seen |= ops
    assert "compact-fetch" in seen
    assert seen <= {"pack", "dispatch", "compact-fetch", "redispatch", "decode"}
    assert ("redispatch" in seen) == bool(stats["compact_windows_redispatched"])


def test_stage_scope_under_threads():
    """Many threads closing scopes at once: every bill and every stamp
    lands."""
    st, n_threads, n_each = _Stats({}), 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(g):
            for _ in range(n_each):
                with st.stage("decode", "decode_s", group=g):
                    pass

        with t_profile.profiling():
            threads = [threading.Thread(target=work, args=(g,)) for g in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(st.stamps) == n_threads * n_each
        assert st.d["decode_s"] == pytest.approx(sum(t1 - t0 for _, t0, t1 in st.stamps))
    finally:
        sys.setswitchinterval(interval)
