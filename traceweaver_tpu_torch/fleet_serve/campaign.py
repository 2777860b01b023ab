"""Wire-level fleet load campaign: 1 against N replicas through real HTTP
(mirrors ``traceweaver_tpu/fleet_serve/campaign.py``).

A closed-loop load generator posts Jaeger JSON over the ingestion wire
(generator -> fleet router -> consistent hash -> replica HTTP server ->
tenant windower) against a 1-replica and an N-replica fleet, and writes
the ``CAMPAIGN_*.json`` artifact the ledger and the regression gate
(:mod:`traceweaver_tpu_torch.campaign`) read.

Drive shape:

- one generator thread a tenant, closed loop (each POST waits for its
  answer; a 429 ``Retry-After`` or a 503 is waited out and the same
  payload retried under the same ``X-TW-Seq``, so nothing is ingested
  twice);
- heavy-tailed tenant rates: tenant *i* posts at a rate in 1/(i+1);
- each POST is one fresh event-time window (trace ids unique per window,
  spans clear of the overlap), so conservation is exact: every ingested
  trace must emit exactly once;
- each N >= 2 rung runs a measured **steady** phase (``spans_per_s``:
  accepted spans over the drive wall; placement rebalanced first), then a
  gated **chaos** phase: the generators resume, the hottest tenant is
  live-migrated mid-post, and in subprocess mode the replica serving it
  is SIGKILLed (the crash supervisor must recover it) and every replica
  takes a rolling restart. The chaos wall stays out of the throughput,
  but its spans ride the rung's zero-loss gate.

A rung fails the campaign, rather than ship a lossy artifact, when the
traces ingested and emitted differ, any window was dropped,
dead-lettered or late, or the generators' acknowledged traces differ
from what the replicas ingested. The payload generators are byte-equal
to the JAX package's. In subprocess mode each replica is a ``cli serve``
process on the card unless ``device`` (``--device``) names another;
``steady.backend_compiles`` and ``aot_misses`` count the replicas' kernel
builds (``nvcc`` at first use) inside the steady phase.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib import error as urlerror
from urllib import request as urlrequest

from traceweaver_tpu_torch.campaign import ledger
from traceweaver_tpu_torch.fleet_serve.manager import (
    FleetManager,
    InProcReplica,
    ReplicaProcess,
)
from traceweaver_tpu_torch.fleet_serve.router import http_json

#: spans per handcrafted hotel trace (frontend -> search -> geo)
SPANS_PER_TRACE = 5

#: serve geometry the corpus is built against (matches the serve
#: defaults the subprocess replicas boot with)
WINDOW_US = 60e6


def fleet_trace(tid: str, base_us: float, i: int,
                spacing_us: float = 10_000.0) -> Dict:
    """One hotel-shaped Jaeger-JSON trace (same 5-span frontend →
    search → geo skeleton as the tier-1 serve corpus; every 6th trace
    plants its latency in ``search``)."""
    T = base_us + i * spacing_us
    slow = (i % 6) == 5
    s1_dur = 5000.0 if slow else 600.0
    c1_dur = s1_dur + 500.0
    root_dur = c1_dur + 400.0

    def span(sid, start, dur, op, refs, pid, kind):
        return dict(traceID=tid, spanID=sid, startTime=start, duration=dur,
                    operationName=op,
                    references=[{"traceID": tid, "spanID": r} for r in refs],
                    processID=pid,
                    tags=[{"key": "span.kind", "value": kind}])

    spans = [
        span("root", T, root_dur, "HTTP GET /hotels", [], "p1", "server"),
        span("c1", T + 200, c1_dur, "call-search", ["root"], "p1", "client"),
        span("s1", T + 300, s1_dur, "search", ["c1"], "p2", "server"),
        span("c2", T + 400, 300.0, "call-geo", ["s1"], "p2", "client"),
        span("s2", T + 450, 200.0, "geo", ["c2"], "p3", "server"),
    ]
    return dict(traceID=tid, spans=spans,
                processes=dict(p1={"serviceName": "frontend"},
                               p2={"serviceName": "search"},
                               p3={"serviceName": "geo"}))


def fleet_payload(tenant: str, seq: int, n_traces: int) -> Dict:
    """One POST body = one fresh event-time window for this tenant.

    ``base_us`` advances a full window stride per seq and lands 10s into
    the window interior, clear of the 5s overlap region on both edges —
    so every trace belongs to exactly one window and the conservation
    check (ingested == emitted, exactly once) is strict."""
    base_us = seq * WINDOW_US + 10e6
    return {"data": [fleet_trace(f"{tenant}w{seq:05d}n{i:03d}",
                                 base_us, i)
                     for i in range(n_traces)]}


class _TenantDrive(threading.Thread):
    """Closed-loop generator for one tenant: POST, await response,
    honor 429 Retry-After (retrying the SAME window payload), pace by
    the tenant's heavy-tail period.

    Pacing is an ABSOLUTE schedule (send k at start + k*period), not
    post-then-sleep: sleeping a full period after each response adds
    the response latency to every cycle, silently under-driving the
    fleet by exactly the latency being measured (coordinated omission —
    the classic closed-loop generator bug). Falling behind schedule
    (a slow response, a 429 wait) is repaid by posting immediately
    until caught up, so the offered load over the phase is the plan's
    rate, and backpressure shows up as 429 counts and latency — never
    as silently reduced offer."""

    def __init__(self, base_url: str, tenant: str, period_s: float,
                 n_traces: int, stop_evt: threading.Event,
                 start_seq: int = 0) -> None:
        super().__init__(name=f"tw-drive-{tenant}", daemon=True)
        self.base_url = base_url
        self.tenant = tenant
        self.period_s = period_s
        self.n_traces = n_traces
        self.stop_evt = stop_evt
        # window sequence cursor: a later drive phase for the same
        # tenant resumes here so event time stays monotonic (a reused
        # seq would land in an already-sealed window as a late span)
        self.seq = start_seq
        self.posts = 0
        self.traces = 0
        self.retry_after_429s = 0
        self.retry_after_503s = 0
        self.deduped = 0
        self.errors: List[str] = []

    def _post(self, payload: Dict) -> Tuple[int, Dict, Dict]:
        data = json.dumps(payload).encode("utf-8")
        # the window seq doubles as the idempotency key: a retry of a
        # POST whose ack died with a killed replica carries the same
        # seq, and the replica's WAL dedup window answers it from the
        # ledger instead of double-ingesting
        req = urlrequest.Request(
            f"{self.base_url}/api/v1/tenants/{self.tenant}/spans",
            data=data, method="POST",
            headers={"Content-Type": "application/json",
                     "X-TW-Seq": str(self.seq)})
        try:
            with urlrequest.urlopen(req, timeout=120) as resp:
                return resp.status, dict(resp.headers), \
                    json.loads(resp.read() or b"{}")
        except urlerror.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                body = {}
            return e.code, dict(e.headers or {}), body

    def run(self) -> None:
        next_send = time.monotonic()
        while not self.stop_evt.is_set():
            payload = fleet_payload(self.tenant, self.seq, self.n_traces)
            while not self.stop_evt.is_set():
                try:
                    status, headers, body = self._post(payload)
                except (urlerror.URLError, OSError) as e:
                    # the router retries/fails internally; a transport
                    # error here means the ROUTER is gone — record, stop
                    self.errors.append(f"seq {self.seq}: {e}")
                    return
                if status == 200:
                    self.posts += 1
                    # count what the replica says it INGESTED, not what
                    # we offered: a dedup echo (the router retried a
                    # POST whose ack died with a crashed replica)
                    # reports the ORIGINAL apply exactly once, keeping
                    # Σ acked == Σ ingested exact under crash-retry
                    self.traces += int(body.get("ingested_traces",
                                                self.n_traces))
                    if body.get("deduped"):
                        self.deduped += 1
                    break
                if status in (429, 503):
                    # 429: replica backpressure. 503 + Retry-After:
                    # degraded mode — the fleet is recovering a crashed
                    # replica; same response either way, wait and retry
                    # the SAME window (the seq header makes it
                    # idempotent, so nothing double-ingests)
                    if status == 429:
                        self.retry_after_429s += 1
                    else:
                        self.retry_after_503s += 1
                    wait = float(headers.get("Retry-After", 1))
                    self.stop_evt.wait(min(wait, 5.0))
                    continue
                self.errors.append(f"seq {self.seq}: HTTP {status}")
                return
            else:
                return  # stopped mid-retry: this window never ingested
            self.seq += 1
            # absolute schedule: wait only until the next slot; if the
            # response (or a 429 wait) overran it, post again at once
            next_send += self.period_s
            delay = next_send - time.monotonic()
            if delay > 0:
                self.stop_evt.wait(delay)


def _build_fleet(n: int, mode: str, state_root: str, serve_args: Optional[List[str]],
                 verbose: bool, device: Optional[str] = None) -> FleetManager:
    names = [f"r{i}" for i in range(n)]
    if mode == "subprocess":
        args = list(serve_args or ["--fix", "2"])
        if device is not None and "--device" not in args:
            args += ["--device", str(device)]
        replicas = []
        try:
            for name in names:
                replicas.append(ReplicaProcess(
                    name, os.path.join(state_root, f"fleet{n}", name),
                    serve_args=args).start())
        except Exception:
            for rep in replicas:
                rep.stop(timeout_s=10.0)
            raise
    elif mode == "inproc":
        from traceweaver_tpu_torch.serve import ServeConfig

        # continuous admission, as the serve CLI's default: the dispatcher
        # and the tickets in flight drain windows while the generators
        # post, so the steady phase measures a serving tier
        replicas = [InProcReplica(name, ServeConfig(
            fix=2, window_us=WINDOW_US, overlap_us=5e6, ooo_bound_us=1e6,
            verbose=False, continuous=True,
            state_dir=os.path.join(state_root, f"fleet{n}", name)), device=device)
            for name in names]
    else:
        raise ValueError(f"unknown fleet campaign mode {mode!r}")
    # subprocess fleets run supervised: the chaos phase SIGKILLs a loaded
    # replica and the crash supervisor must bring it back
    return FleetManager(replicas, router_port=0, verbose=verbose,
                        supervise=(mode == "subprocess"))


def _aggregate(fleet: FleetManager) -> Dict[str, object]:
    """Fleet-wide conservation ledger from the per-replica stats (each
    live tenant appears on exactly one replica: migration deletes it
    from the source and tombstones the id), with each replica's
    ``kernels`` block."""
    stats = fleet.router.fleet_stats(include_replicas=True)
    agg = dict(ingested_traces=0, ingested_spans=0, traces_emitted=0,
               spans_emitted=0, shed_dropped_windows=0,
               deadletter_windows=0, late_dropped=0, quarantined=0,
               backlog=0, backpressure_429s=0,
               parse_s=0.0, stitch_s=0.0, emit_s=0.0,
               serve_busy_s=0.0, serve_union_s=0.0, serve_inflight=0)
    p99 = {}
    per_tenant = {}
    kernels = {}
    for name, st in stats["replica_stats"].items():
        if "error" in st:
            raise RuntimeError(f"replica {name} stats: {st['error']}")
        kernels[name] = st.get("kernels") or {}
        agg["backpressure_429s"] += int(
            st.get("dispatch", {}).get("backpressure_429s", 0))
        # the dispatch ring's overlap ledger: replicas dispatch
        # independently, so busy and union seconds sum across the fleet
        ring = st.get("ring", {}) or {}
        agg["serve_busy_s"] += float(ring.get("busy_s", 0.0))
        agg["serve_union_s"] += float(ring.get("union_s", 0.0))
        agg["serve_inflight"] = max(agg["serve_inflight"],
                                    int(ring.get("inflight_limit", 0)))
        for tid, ts in st.get("tenants", {}).items():
            c = ts.get("counters", {})
            agg["ingested_traces"] += int(c.get("ingested_traces", 0))
            agg["ingested_spans"] += int(c.get("ingested_spans", 0))
            agg["traces_emitted"] += int(ts.get("traces_emitted", 0))
            agg["spans_emitted"] += int(ts.get("spans_emitted", 0))
            agg["shed_dropped_windows"] += int(
                ts.get("shed_dropped_windows", 0))
            agg["deadletter_windows"] += int(
                ts.get("deadletter_windows", 0))
            agg["late_dropped"] += int(ts.get("late_dropped", 0))
            agg["quarantined"] += int(ts.get("quarantined_windows", 0))
            agg["backlog"] += int(ts.get("backlog", 0))
            agg["parse_s"] += float(ts.get("parse_s", 0.0))
            agg["stitch_s"] += float(ts.get("stitch_s", 0.0))
            agg["emit_s"] += float(ts.get("emit_s", 0.0))
            p99[tid] = float(ts.get("seal_emit_p99_ms", 0.0))
            per_tenant[f"{name}/{tid}"] = dict(
                ingested=int(c.get("ingested_traces", 0)),
                emitted=int(ts.get("traces_emitted", 0)),
                backlog=int(ts.get("backlog", 0)),
                solved_windows=int(ts.get("solved_windows", 0)),
                spilled=int(ts.get("shed_spilled", 0)),
            )
    agg["per_tenant"] = per_tenant
    agg["seal_emit_p99_ms"] = p99
    agg["router"] = stats["router"]
    agg["kernels"] = kernels
    return agg


def _kernel_builds(agg: Dict, mode: str) -> List[str]:
    """The kernel sources the fleet's replica processes built, in order
    (in-process replicas share one process, so one list)."""
    lists = [k.get("built", []) for _, k in sorted(agg["kernels"].items())]
    if mode == "inproc":
        return list(lists[0]) if lists else []
    return [src for built in lists for src in built]


def _settle(fleet: FleetManager, timeout_s: float = 60.0) -> Dict:
    """Post-flush quiesce: a replica's continuous dispatcher may still
    be mid-solve when the flush response lands, so poll the aggregate
    until the conservation ledger balances (or stops moving)."""
    deadline = time.monotonic() + timeout_s
    agg = _aggregate(fleet)
    while time.monotonic() < deadline:
        if (agg["traces_emitted"] == agg["ingested_traces"]
                and agg["backlog"] == 0):
            break
        time.sleep(0.25)
        agg = _aggregate(fleet)
    return agg


def _rebalance(fleet: FleetManager, tenant_ids: List[str],
               verbose: bool) -> int:
    """Pre-measurement placement fix: the hash ring can land every
    tenant on one replica (3 ids, 2 replicas — a 3/0 split is a coin
    flip), which would measure a 1-replica fleet twice. Live-migrate
    the hottest tenant from the fullest replica onto each EMPTY one —
    the load-balancing use of the migration machinery."""
    moved = 0
    placement = {name: fleet.replica_tenants(name)
                 for name in sorted(fleet.router.replicas)}
    for name in sorted(placement):
        if placement[name]:
            continue
        donor = max(sorted(placement), key=lambda r: len(placement[r]))
        if len(placement[donor]) < 2:
            break
        # hottest tenant present on the donor (drive rate ∝ 1/(i+1))
        tid = next(t for t in tenant_ids if t in placement[donor])
        fleet.migrate(tid, name)
        placement[donor].remove(tid)
        placement[name] = [tid]
        moved += 1
        if verbose:
            print(f"[fleet-campaign] rebalance: {tid} -> {name}")
    return moved


def _flush_fleet(fleet: FleetManager, n: int) -> None:
    # the fan-out flush crosses every replica; a connection reset here
    # (a replica's listener mid-close from a just-finished restart) is
    # retryable — flush is idempotent, sealing is driven by event time
    last: Optional[BaseException] = None
    for _ in range(3):
        try:
            status, flush = http_json(
                "POST", fleet.base_url + "/api/v1/flush", None,
                timeout=300)
        except (urlerror.URLError, OSError) as e:
            last = e
            time.sleep(0.5)
            continue
        if status != 200:
            raise RuntimeError(f"fleet-{n} flush: HTTP {status} {flush}")
        return
    raise RuntimeError(f"fleet-{n} flush failed: {last}")


def run_fleet_rung(n: int, mode: str, state_root: str, tenants: int,
                   seconds: float, traces_per_post: int,
                   base_period_s: float, serve_args: Optional[List[str]],
                   verbose: bool, device: Optional[str] = None) -> Dict[str, object]:
    """One campaign rung, two phases on one fresh n-replica fleet:

    - **steady** (measured): closed-loop drive through the router for
      ``seconds`` — ``spans_per_s`` is ACCEPTED spans (200-status
      POSTs) over the drive wall, the wire capacity the 1-vs-N
      comparison is about — followed by a flush + settle that forces
      every accepted span to emit before the phase may end;
    - **chaos** (n >= 2, gated not measured): the generators resume
      (continuing their window sequence) while the hot tenant is
      live-migrated, then — subprocess mode — the replica serving it
      is SIGKILLed mid-post (crash supervisor recovers; acked spans
      ride the ingest WAL) and every replica takes a rolling restart;
      a final flush + settle feeds the rung-wide zero-loss gate, so
      the failover machinery must be lossless under live load even
      though its wall cost (full process restarts) stays out of the
      throughput figure."""
    fleet = _build_fleet(n, mode, state_root, serve_args, verbose, device)
    tenant_ids = [f"ten{i}" for i in range(tenants)]

    def mk_drives(stop_evt: threading.Event,
                  seqs: Dict[str, int]) -> List[_TenantDrive]:
        return [_TenantDrive(fleet.base_url, tid,
                             period_s=base_period_s * (i + 1),
                             n_traces=traces_per_post, stop_evt=stop_evt,
                             start_seq=seqs.get(tid, 0))
                for i, tid in enumerate(tenant_ids)]

    def drain_drives(drives: List[_TenantDrive]) -> None:
        for d in drives:
            d.join(timeout=130.0)
        errors = [e for d in drives for e in d.errors]
        if errors:
            raise RuntimeError(f"fleet-{n} drive errors: {errors[:5]}")

    wall_t0 = time.monotonic()
    migrated = restarted = rebalanced = killed = 0
    all_drives: List[_TenantDrive] = []
    try:
        # -- warmup (untimed): first-contact EM and kernel loading --------
        # the steady figure is a steady-state claim: the cold solves of
        # the first windows (the two-pass EM, the kernels' first use) are
        # startup cost. Drive briefly, flush and settle so the continuous
        # dispatchers enter the measured phase warm, and fix the tenants'
        # placement before measuring (a migration inside the drive would
        # put its wall in the throughput figure)
        stop_w = threading.Event()
        drives_w = mk_drives(stop_w, {})
        all_drives += drives_w
        for d in drives_w:
            d.start()
        stop_w.wait(max(1.0, min(3.0, seconds / 4)))
        stop_w.set()
        drain_drives(drives_w)
        _flush_fleet(fleet, n)
        _settle(fleet)
        if n >= 2:
            rebalanced = _rebalance(fleet, tenant_ids, verbose)
        # warmup windows sat sealed until the flush above, so their
        # seal→emit samples measure the flush wait, not the drain —
        # start the p99 window fresh so the SLO gate sees steady only
        for rep in fleet.replicas.values():
            http_json("POST", rep.base_url + "/api/v1/reset_latency_window",
                      None, timeout=30)

        # -- steady phase (the measured one) ------------------------------
        builds_before = _kernel_builds(_aggregate(fleet), mode)
        t0 = time.monotonic()
        stop_a = threading.Event()
        drives_a = mk_drives(stop_a, {d.tenant: d.seq for d in drives_w})
        all_drives += drives_a
        for d in drives_a:
            d.start()
        while time.monotonic() < t0 + seconds:
            time.sleep(0.05)
        stop_a.set()
        drain_drives(drives_a)
        # the wire throughput figure: spans the closed-loop generators
        # got a 200 for, over the drive wall (including the last POSTs'
        # response tails). Acceptance is what adding replicas scales on
        # any host — emitted-spans/s is bounded by total solve cores,
        # which a 1-core CI host pins to the same ceiling for every N.
        # The flush + settle below still forces every accepted span to
        # EMIT exactly once before the rung may return (the zero-loss
        # gate), so acceptance is never credit for vapor.
        drive_wall_s = time.monotonic() - t0
        steady_spans = sum(d.traces for d in drives_a) * SPANS_PER_TRACE
        _flush_fleet(fleet, n)
        agg = _settle(fleet)
        steady_wall_s = time.monotonic() - t0
        steady_builds = _kernel_builds(agg, mode)[len(builds_before):]
        steady_kernels = agg["kernels"]

        # -- chaos phase (gated, unmeasured) ------------------------------
        chaos_t0 = time.monotonic()
        if n >= 2:
            stop_b = threading.Event()
            drives_b = mk_drives(stop_b, {d.tenant: d.seq
                                          for d in drives_a})
            all_drives += drives_b
            for d in drives_b:
                d.start()
            time.sleep(0.3)
            hot = tenant_ids[0]
            src = fleet.router.owner(hot)
            dst = next(name for name in sorted(fleet.router.replicas)
                       if name != src)
            fleet.migrate(hot, dst)
            migrated += 1
            if mode == "subprocess":
                # SIGKILL the replica now serving the hot tenant while its
                # generator is mid-post: no drain, no checkpoint. The
                # crash supervisor must see it and recover it (a respawn
                # with WAL replay, or a survivor failover from the dead
                # disk), and the rung's conservation gate must still
                # balance exactly: acknowledged spans survive the kill or
                # the campaign fails
                victim = fleet.router.owner(hot)
                vrep = fleet.replicas[victim]
                vrep.proc.kill()
                killed += 1
                deadline = time.monotonic() + 120.0
                while time.monotonic() < deadline:
                    c = fleet.router.counters
                    if c.get("respawns", 0) + c.get("failovers", 0) >= 1:
                        break
                    time.sleep(0.2)
                else:
                    raise RuntimeError(
                        f"fleet-{n} chaos: supervisor never recovered "
                        f"{victim} after SIGKILL")
                fleet.rolling_restart()
                restarted = len(fleet.replicas)
            # post-chaos burst: the fleet must still be ingesting after
            # the migration + restarts, not merely draining
            time.sleep(max(0.5, seconds / 8))
            stop_b.set()
            drain_drives(drives_b)
            _flush_fleet(fleet, n)
            agg = _settle(fleet)
        chaos_wall_s = time.monotonic() - chaos_t0
        wall_s = time.monotonic() - wall_t0
    except Exception:
        if verbose:
            # a replica process's own account of the failure
            for rep in fleet.replicas.values():
                for line in getattr(rep, "log", [])[-15:]:
                    print(f"[fleet-campaign] {rep.name}: {line}", flush=True)
        raise
    finally:
        fleet.stop()

    # the zero-loss gate: a lossy fleet does not get an artifact
    lost = agg["ingested_traces"] - agg["traces_emitted"]
    if lost != 0 or agg["shed_dropped_windows"] or \
            agg["deadletter_windows"] or agg["late_dropped"] or \
            agg["backlog"]:
        raise RuntimeError(
            f"fleet-{n} lost traces: ingested {agg['ingested_traces']} "
            f"emitted {agg['traces_emitted']} (delta {lost}), dropped "
            f"windows {agg['shed_dropped_windows']}, deadletter "
            f"{agg['deadletter_windows']}, late_dropped "
            f"{agg['late_dropped']}, backlog {agg['backlog']}; "
            f"per-tenant {json.dumps(agg['per_tenant'], sort_keys=True)}")
    posted = sum(d.traces for d in all_drives)
    if posted != agg["ingested_traces"]:
        raise RuntimeError(
            f"fleet-{n} wire loss: generators got 200 for {posted} "
            f"traces, replicas ingested {agg['ingested_traces']}")
    e2e_pct = (100.0 * agg["traces_emitted"] / agg["ingested_traces"]
               if agg["ingested_traces"] else 0.0)
    spans_per_s = (steady_spans / drive_wall_s
                   if drive_wall_s > 0 else 0.0)
    return dict(
        rung=f"fleet-{n}",
        manifest=dict(
            spans=int(agg["ingested_spans"]),
            traces=int(agg["ingested_traces"]),
            tenants=tenants, replicas=n, mode=mode,
            posts=sum(d.posts for d in all_drives),
            regime_mix={},
        ),
        steady=dict(
            spans_per_s=round(spans_per_s, 2),
            backend_compiles=len(steady_builds),
            aot_misses=sorted(set(steady_builds)),
            quarantined=int(agg["quarantined"]),
        ),
        accuracy=dict(e2e_pct=round(e2e_pct, 3), per_regime={}),
        fleet=dict(
            wall_s=round(wall_s, 3),
            drive_wall_s=round(drive_wall_s, 3),
            steady_wall_s=round(steady_wall_s, 3),
            chaos_wall_s=round(chaos_wall_s, 3),
            steady_accepted_spans=steady_spans,
            seal_emit_p99_ms=agg["seal_emit_p99_ms"],
            router=agg["router"],
            migrations=migrated + rebalanced,
            rebalance_migrations=rebalanced,
            replicas_restarted=restarted,
            backpressure_429s=int(agg["backpressure_429s"]),
            generator_429s=sum(d.retry_after_429s for d in all_drives),
            generator_503s=sum(d.retry_after_503s for d in all_drives),
            deduped_windows=sum(d.deduped for d in all_drives),
            crash_kills=killed,
            respawns=int(agg["router"]["counters"].get("respawns", 0)),
            crash_failovers=int(
                agg["router"]["counters"].get("failovers", 0)),
            reset_midbody=int(
                agg["router"]["counters"].get("reset_midbody", 0)),
            parse_s=round(float(agg["parse_s"]), 4),
            stitch_s=round(float(agg["stitch_s"]), 4),
            emit_s=round(float(agg["emit_s"]), 4),
            serve_inflight=int(agg["serve_inflight"]),
            serve_overlap_pct=round(
                max(0.0, 100.0 * (1.0 - float(agg["serve_union_s"])
                                  / float(agg["serve_busy_s"])))
                if float(agg["serve_busy_s"]) > 0 else 0.0, 2),
            kernels_steady=steady_kernels,
            kernels_final=agg["kernels"],
            zero_loss=True,
        ),
    )


def run_fleet_campaign(state_root: str,
                       replica_counts: Tuple[int, ...] = (1, 2),
                       tenants: int = 3,
                       seconds: float = 6.0,
                       traces_per_post: int = 6,
                       base_period_s: float = 0.05,
                       mode: str = "subprocess",
                       name: str = "fleet-wire",
                       out: Optional[str] = None,
                       serve_args: Optional[List[str]] = None,
                       verbose: bool = False,
                       device: Optional[str] = None) -> Dict[str, object]:
    """Drive the campaign ladder (one rung a replica count) and return,
    and with ``out`` write, the gated ``CAMPAIGN_*`` artifact. ``device``
    is the replicas' (None: the card)."""
    plan = dict(
        mode=mode, tenants=tenants, seconds=seconds,
        traces_per_post=traces_per_post, base_period_s=base_period_s,
        replica_counts=list(replica_counts), device=device,
        rungs=[dict(name=f"fleet-{n}") for n in replica_counts],
    )
    ledger.record_start(name, plan)
    t0 = time.monotonic()
    rungs = []
    for n in replica_counts:
        rung = run_fleet_rung(
            n, mode, state_root, tenants, seconds, traces_per_post,
            base_period_s, serve_args, verbose, device)
        ledger.record_rung(name, rung["rung"],
                           rung["steady"]["spans_per_s"],
                           rung["accuracy"]["e2e_pct"],
                           rung["steady"]["backend_compiles"],
                           len(rung["steady"]["aot_misses"]))
        if verbose:
            print(f"[fleet-campaign] {rung['rung']}: "
                  f"{rung['steady']['spans_per_s']:.1f} spans/s, "
                  f"e2e {rung['accuracy']['e2e_pct']:.1f}%, "
                  f"migrations {rung['fleet']['migrations']}, "
                  f"restarts {rung['fleet']['replicas_restarted']}")
        rungs.append(rung)
    wall_s = time.monotonic() - t0
    artifact = ledger.make_artifact(
        name=name, plan=plan, backend="wire", devices_visible=0,
        rungs=rungs, scrape=ledger.scrape_snapshot(), wall_s=wall_s)
    if out:
        ledger.write_artifact(out, artifact)
    ledger.record_finish(name, wall_s, out)
    return artifact
