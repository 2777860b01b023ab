"""The port's multi-process tier against the JAX package's (CPU).

- the numpy helpers (``partition_problems``, ``merge_edge_stats``,
  ``edge_stats_from_samples``, ``stats_to_rows``) equal JAX's on the
  same inputs, and the filesystem transport equals the host merge;
- two ranks of a gloo process group: ``allreduce_stats_dist`` equals the
  filesystem transport and the host merge exactly (f64; integer-valued
  microsecond delays whose sums of squares pass f32's exact range), as
  the JAX package's ``tests/test_multislice.py`` asserts for its
  transport at two processes;
- two ranks each solve their ``partition_problems`` share of a small
  synthesized campaign rung through ``solve_fleet`` on the CPU and
  reduce the solved edge statistics through both transports: the
  transports agree, and each service's accuracy equals the one-process
  run's.

Each spawned rank has its own timeout (90 s) and its process group one
of 60 s.
"""

import json
import os
import random
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from traceweaver_tpu_torch.parallel import multislice as tms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 90


def _samples(pid):
    # ms-scale microsecond delays: sums of squares near 3e9 pass f32's
    # exactly representable range, so only an f64 reduction is exact
    return {("svc", f"ep{pid}"): [40000.0 + pid, 41000.0 + 2 * pid],
            ("svc", "shared"): [39500.0 + pid]}


EDGE_ORDER = [("svc", "ep0"), ("svc", "ep1"), ("svc", "shared")]


@pytest.mark.parametrize("n_problems,n_processes", [(10, 3), (7, 2), (2, 4), (15, 2)])
def test_partition_matches_jax(n_problems, n_processes):
    from traceweaver_tpu.parallel.multislice import partition_problems as j_part

    parts = [tms.partition_problems(n_problems, n_processes, p) for p in range(n_processes)]
    assert parts == [j_part(n_problems, n_processes, p) for p in range(n_processes)]
    assert sorted(i for part in parts for i in part) == list(range(n_problems))


def test_stats_helpers_match_jax():
    from traceweaver_tpu.parallel import multislice as jms

    shards = [tms.edge_stats_from_samples(_samples(p)) for p in range(2)]
    assert shards == [jms.edge_stats_from_samples(_samples(p)) for p in range(2)]
    merged = tms.merge_edge_stats(shards[0], shards[1:])
    assert merged == jms.merge_edge_stats(shards[0], shards[1:])
    assert np.array_equal(tms.stats_to_rows(merged, EDGE_ORDER),
                          jms.stats_to_rows(merged, EDGE_ORDER))
    n, s1, _ = merged[("svc", "shared")]
    assert s1 / n == 39500.5


def test_file_transport_equals_host_merge(tmp_path):
    shards = [tms.edge_stats_from_samples(_samples(p)) for p in range(2)]
    got = [None, None]

    def rank(p):
        got[p] = tms.allreduce_stats_files(shards[p], str(tmp_path), p, 2, timeout_s=30)

    threads = [threading.Thread(target=rank, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert got[0] == got[1] == tms.merge_edge_stats(shards[0], shards[1:])
    with pytest.raises(TimeoutError):
        tms.allreduce_stats_files(shards[0], str(tmp_path), 0, 2, timeout_s=0.2,
                                  round_id=1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DIST_WORKER = r"""
import datetime, json, sys
import numpy as np
import torch.distributed as dist
pid, n, port, repo, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
sys.path.insert(0, repo)
from traceweaver_tpu_torch.parallel.multislice import (
    allreduce_stats_dist, allreduce_stats_files, edge_stats_from_samples, stats_to_rows)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port, world_size=n,
                        rank=pid, timeout=datetime.timedelta(seconds=60))
samples = {("svc", "ep%d" % pid): [40000.0 + pid, 41000.0 + 2 * pid],
           ("svc", "shared"): [39500.0 + pid]}
stats = edge_stats_from_samples(samples)
order = [("svc", "ep0"), ("svc", "ep1"), ("svc", "shared")]
merged = allreduce_stats_dist(stats_to_rows(stats, order))
files = stats_to_rows(allreduce_stats_files(stats, rdv, pid, n, timeout_s=60), order)
dist.destroy_process_group()
print(json.dumps({"pid": pid, "dist": merged.tolist(), "files": files.tolist()}), flush=True)
"""


def _run_ranks(code, args_of, n=2):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, *args_of(p)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for p in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_rank_dist_transport_equals_files(tmp_path):
    port = str(_free_port())
    outs = _run_ranks(DIST_WORKER, lambda p: [str(p), "2", port, REPO, str(tmp_path)])
    shards = [tms.edge_stats_from_samples(_samples(p)) for p in range(2)]
    want = tms.stats_to_rows(tms.merge_edge_stats(shards[0], shards[1:]), EDGE_ORDER)
    for o in outs:
        # exact: integer-valued inputs, f64 sums
        assert np.array_equal(np.asarray(o["dist"]), want)
        assert np.array_equal(np.asarray(o["files"]), want)


SOLVE_WORKER = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
pid, n, port, repo, rdv, cache = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                  sys.argv[4], sys.argv[5], sys.argv[6])
sys.path.insert(0, repo)
from tests.test_torch_multislice import rank_solve
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port, world_size=n,
                        rank=pid, timeout=datetime.timedelta(seconds=60))
out = rank_solve(cache, rdv, pid, n)
dist.destroy_process_group()
print(json.dumps(out), flush=True)
"""


def _rung():
    from traceweaver_tpu_torch.campaign.plan import RungSpec

    return RungSpec("ms", n_graphs=2, traces_per_graph=24, gap_ms=400, seed=3,
                    n_services=8, source="synthetic")


def _accuracies(corpus, idx, outs):
    from traceweaver_tpu_torch.metrics import accuracy_for_service

    return {"%d:%s" % (corpus.problems[i]["store"], corpus.problems[i]["svc"]):
            accuracy_for_service(o[0], corpus.problems[i]["true"],
                                 corpus.problems[i]["prob"].in_span_partitions)
            for i, o in zip(idx, outs)}


def edge_order(corpus):
    return sorted({(m["svc"], ep) for m in corpus.problems
                   for ep in m["prob"].out_span_partitions})


def rank_solve(cache, rdv, pid, n):
    """One rank: its share of the rung through ``solve_fleet`` on the CPU,
    then the solved edge statistics through both transports."""
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.campaign.corpus import build_rung
    from traceweaver_tpu_torch.campaign.runner import rung_items, slice_edge_stats

    # ``-loop`` service names draw from the global ``random``: every rank
    # seeds it alike, so the edge keys agree across ranks
    random.seed(0)
    corpus = build_rung(_rung(), cache)
    mine = tms.partition_problems(len(corpus.problems), n, pid)
    outs = solve_fleet(rung_items(corpus, mine), device="cpu")
    by_index = dict(zip(mine, outs))
    stats = slice_edge_stats(corpus, by_index, n, pid)
    order = edge_order(corpus)
    dist_rows = tms.allreduce_stats_dist(tms.stats_to_rows(stats, order))
    files = tms.stats_to_rows(tms.allreduce_stats_files(stats, rdv, pid, n, timeout_s=60),
                              order)
    return dict(pid=pid, accs=_accuracies(corpus, mine, outs), dist=dist_rows.tolist(),
                files=files.tolist())


def test_two_rank_campaign_share_solve(tmp_path):
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.campaign.corpus import build_rung
    from traceweaver_tpu_torch.campaign.runner import rung_items

    cache = str(tmp_path / "cache")
    # built once (its manifest written), so the ranks find it cached
    build_rung(_rung(), cache)
    port = str(_free_port())
    outs = _run_ranks(SOLVE_WORKER, lambda p: [str(p), "2", port, REPO,
                                               str(tmp_path / "rdv"), cache])
    for o in outs:
        assert np.array_equal(np.asarray(o["dist"]), np.asarray(o["files"]))
    assert outs[0]["dist"] == outs[1]["dist"]
    accs = {**outs[0]["accs"], **outs[1]["accs"]}
    assert outs[0]["accs"] and outs[1]["accs"]
    assert not set(outs[0]["accs"]) & set(outs[1]["accs"])

    random.seed(0)
    corpus = build_rung(_rung(), cache)
    idx = list(range(len(corpus.problems)))
    one = _accuracies(corpus, idx, solve_fleet(rung_items(corpus, idx), device="cpu"))
    assert accs == one
