"""Multi-process scale-out: corpus-level data parallelism (mirrors
``traceweaver_tpu/parallel/multislice.py``).

Three tiers, matched to the machine's communication hierarchy:

1. **Within a device**: the window batch (a leading batch axis).
2. **Within a process**: the window axis sharded over a mesh of devices
   (:mod:`traceweaver_tpu_torch.parallel.mesh`); windows are
   independent, so the solve needs no traffic between shards, and only
   the EM M-step reduces ``[Ne, K]``-shaped moment sums.
3. **Across processes or hosts**: this module. The unit of work is a
   whole assignment problem (one call graph, or one service's span
   partitions): problems are range-partitioned across processes, each
   process solves its share with the full single-process stack, and the
   only traffic between processes is an optional allreduce of per-edge
   delay statistics (when one set of distributions is fit corpus-wide)
   and the gather of results. Both are O(edges) and O(results).

Two transports carry the allreduce, and give the same numbers:

- :func:`allreduce_stats_dist`: one ``torch.distributed.all_reduce`` of
  an f64 CPU tensor over an initialised process group (gloo, on either
  machine; the JAX package's ``allreduce_stats_jax`` is one XLA ``psum``
  over a global mesh);
- :func:`allreduce_stats_files`: a filesystem barrier and reduce, for
  plain OS processes.

With two processes the sum is ``a + b`` either way, so the two agree
exactly (``tests/test_torch_multislice.py`` asserts it at two ranks, as
the JAX package's tests do).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

EdgeKey = Tuple[str, str]


def partition_problems(n_problems: int, n_processes: int,
                       process_id: int) -> List[int]:
    """Contiguous range partition of problem indices for one process.

    Call graphs are grouped by signature (alibaba/grouping.py), so
    neighbouring indices have similar sizes; contiguous ranges keep the
    shares' costs roughly balanced without a scheduler."""
    assert 0 <= process_id < n_processes
    base, extra = divmod(n_problems, n_processes)
    lo = process_id * base + min(process_id, extra)
    hi = lo + base + (1 if process_id < extra else 0)
    return list(range(lo, hi))


def merge_edge_stats(
    local: Dict[EdgeKey, Tuple[float, float, float]],
    others: Sequence[Dict[EdgeKey, Tuple[float, float, float]]],
) -> Dict[EdgeKey, Tuple[float, float, float]]:
    """Reduce per-edge ``(n, Σd, Σd²)`` sufficient statistics across
    shares. They are additive, so the corpus-wide Gaussian is recovered
    exactly: ``mean = Σd/n``, ``var = Σd²/n − mean²``."""
    out: Dict[EdgeKey, list] = {k: list(v) for k, v in local.items()}
    for d in others:
        for k, (n, s1, s2) in d.items():
            if k in out:
                out[k][0] += n
                out[k][1] += s1
                out[k][2] += s2
            else:
                out[k] = [n, s1, s2]
    return {k: (v[0], v[1], v[2]) for k, v in out.items()}


def edge_stats_from_samples(
    samples_by_edge: Dict[EdgeKey, Sequence[float]],
) -> Dict[EdgeKey, Tuple[float, float, float]]:
    """Local ``(n, Σd, Σd²)`` per edge from raw delay samples, in f64."""
    out = {}
    for k, v in samples_by_edge.items():
        a = np.asarray(v, dtype=np.float64)
        out[k] = (float(len(a)), float(a.sum()), float((a * a).sum()))
    return out


def stats_to_rows(
    stats: Dict[EdgeKey, Tuple[float, float, float]],
    edge_order: Sequence[EdgeKey],
) -> np.ndarray:
    """Dense ``[len(edge_order), 3]`` view of per-edge stats (absent edges
    are zero rows, the additive identity, so reductions stay exact)."""
    rows = np.zeros((len(edge_order), 3), dtype=np.float64)
    for i, k in enumerate(edge_order):
        if k in stats:
            rows[i] = stats[k]
    return rows


def allreduce_stats_dist(local_rows: np.ndarray, group=None) -> np.ndarray:
    """The ``torch.distributed`` transport: one ``all_reduce`` (sum) of
    the stacked per-edge statistics over ``group`` (the default process
    group when None).

    Every rank calls it with a same-shaped ``[rows, 3]`` array, after
    ``torch.distributed.init_process_group`` (gloo: the tensor is a CPU
    tensor, on the machine with the card too). The reduction runs in
    f64: the stats are ``(n, Σd, Σd²)``, and ``Σd²`` of microsecond
    delays over a large corpus passes 1e13, where f32 would lose the
    variance to cancellation and part from the filesystem transport.
    Returns the merged rows, the same on every rank."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("allreduce_stats_dist needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    t = torch.as_tensor(np.ascontiguousarray(local_rows, dtype=np.float64)).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.numpy()


def allreduce_stats_files(
    stats: Dict[EdgeKey, Tuple[float, float, float]],
    rendezvous_dir: str,
    process_id: int,
    n_processes: int,
    timeout_s: float = 120.0,
    poll_s: float = 0.05,
    round_id: int = 0,
) -> Dict[EdgeKey, Tuple[float, float, float]]:
    """Filesystem allreduce: every process writes its local stats, waits
    for all peers, and computes the identical merged result.

    ``round_id`` namespaces the barrier files: repeated reductions over
    the same rendezvous directory (one per EM iteration, or a restarted
    run) must pass distinct round ids, else a peer's stale file from an
    earlier round would satisfy the barrier and merge wrong statistics.
    """
    os.makedirs(rendezvous_dir, exist_ok=True)
    payload = {json.dumps(list(k)): v for k, v in stats.items()}
    tmp = os.path.join(rendezvous_dir, f".stats_r{round_id}_{process_id}.tmp")
    final = os.path.join(rendezvous_dir, f"stats_r{round_id}_{process_id}.json")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, final)  # atomic publish

    deadline = time.time() + timeout_s
    paths = [os.path.join(rendezvous_dir, f"stats_r{round_id}_{p}.json")
             for p in range(n_processes)]
    while not all(os.path.exists(p) for p in paths):
        if time.time() > deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise TimeoutError(f"allreduce barrier: missing {missing}")
        time.sleep(poll_s)

    shards = []
    for p in paths:
        with open(p) as f:
            raw = json.load(f)
        shards.append({tuple(json.loads(k)): tuple(v) for k, v in raw.items()})
    return merge_edge_stats(shards[0], shards[1:])
