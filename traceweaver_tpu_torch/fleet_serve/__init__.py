"""Replica fleet tier: tenant-sharded serving across replica processes
(mirrors ``traceweaver_tpu/fleet_serve/__init__.py``).

One router (:mod:`.router`) consistent-hashes tenant ids onto N replica
serve processes that share nothing, probes their health, breaks
circuits, retries POSTs on the next replica in ring order and
coordinates live tenant migration (checkpoint transfer and resume, the
sink byte-identical, no span lost). The manager (:mod:`.manager`) owns
the replicas' lifecycle: spawn, migrate, rolling restart gated on
``/readyz``, and the crash supervisor (respawn with WAL replay, or
survivor failover from the dead disk). The wire campaign
(:mod:`.campaign`) drives the fleet over HTTP and writes the gated
``CAMPAIGN_*`` artifact (:mod:`traceweaver_tpu_torch.campaign`).

The fleet's own process imports no CUDA: each replica owns its card
context. A replica runs on the card unless the serve flags passed
through hold ``--device cpu``; with no card and no ``--device`` each
replica exits 2, and ``fleet serve`` reports the :class:`ReplicaError`
and exits 1.

CLI (``python -m traceweaver_tpu_torch.runtime.cli fleet ...``)::

    fleet serve    --replicas N --port P --state-dir D
                   [-- serve flags, e.g. --fix 2 --device cpu]
    fleet campaign --replicas 1,2 --seconds S --tenants T
                   --state-dir D [--mode subprocess|inproc] [--device cpu]
                   [--out CAMPAIGN_fleet.json]

The JAX package's ``TW_FLEET_*`` knobs are flags with the knobs'
defaults and ranges.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from typing import List

from traceweaver_tpu_torch.fleet_serve.manager import (
    FleetManager,
    InProcReplica,
    ReplicaError,
    ReplicaProcess,
)
from traceweaver_tpu_torch.fleet_serve.router import (
    BREAKER_COOLDOWN_S,
    BREAKER_FAILS,
    HEALTH_S,
    MIGRATE_TIMEOUT_S,
    PROXY_TIMEOUT_S,
    RETRY_MAX,
    ROUTER_PORT,
    VNODES,
    CircuitBreaker,
    FleetRouter,
    HashRing,
    ReplicaRef,
    check_range,
)

__all__ = [
    "CircuitBreaker",
    "FleetManager",
    "FleetRouter",
    "HashRing",
    "InProcReplica",
    "ReplicaError",
    "ReplicaProcess",
    "ReplicaRef",
    "main",
]

#: ``TW_FLEET_REPLICAS``'s default
REPLICAS = 2


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.runtime.cli fleet",
        description="Tenant-sharded replica fleet: a router and N serve replicas "
                    "with live migration, rolling restarts and crash recovery.")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="spawn N replica serve processes behind one "
                                     "router and serve until SIGTERM or SIGINT")
    s.add_argument("--replicas", type=int, default=REPLICAS,
                   help="replica count (TW_FLEET_REPLICAS, 1-64)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=ROUTER_PORT,
                   help="router port (TW_FLEET_ROUTER_PORT; 0 = a free port)")
    s.add_argument("--state-dir", required=True,
                   help="fleet state root; replica i keeps its tenants under "
                        "<state-dir>/r<i>/")
    s.add_argument("--retry-max", type=int, default=RETRY_MAX,
                   help="extra attempts of a failed POST (TW_FLEET_RETRY_MAX, 0-16)")
    s.add_argument("--vnodes", type=int, default=VNODES,
                   help="virtual nodes a replica (TW_FLEET_VNODES, 1-4096)")
    s.add_argument("--breaker-fails", type=int, default=BREAKER_FAILS,
                   help="failures that open a circuit (TW_FLEET_BREAKER_FAILS, 1-100)")
    s.add_argument("--breaker-cooldown-s", type=float, default=BREAKER_COOLDOWN_S,
                   help="open-circuit cooldown (TW_FLEET_BREAKER_COOLDOWN_S, 0.1-600)")
    s.add_argument("--health-s", type=float, default=HEALTH_S,
                   help="health-probe period (TW_FLEET_HEALTH_S, 0.05-60)")
    s.add_argument("--proxy-timeout-s", type=float, default=PROXY_TIMEOUT_S,
                   help="one proxied attempt's timeout (TW_FLEET_PROXY_TIMEOUT_S, "
                        "0.1-3600)")
    s.add_argument("--migrate-timeout-s", type=float, default=MIGRATE_TIMEOUT_S,
                   help="a migration's budget and the longest wait on a hold, "
                        "after which a held request is answered 503 "
                        "(TW_FLEET_MIGRATE_TIMEOUT_S, 0.1-3600)")
    s.add_argument("serve_args", nargs="*",
                   help="flags passed to every replica's `cli serve` after `--` "
                        "(e.g. -- --fix 2 --device cpu)")

    c = sub.add_parser("campaign", help="wire-level load campaign: 1 against N replicas "
                                        "through the HTTP path, gated artifact out")
    c.add_argument("--replicas", default="1,2",
                   help="comma-separated rung ladder (default 1,2)")
    c.add_argument("--tenants", type=int, default=3)
    c.add_argument("--seconds", type=float, default=6.0, help="drive seconds a rung")
    c.add_argument("--traces-per-post", type=int, default=6)
    c.add_argument("--base-period-s", type=float, default=0.05,
                   help="the hot tenant's closed-loop pacing; tenant i runs at "
                        "(i+1) times this period")
    c.add_argument("--mode", choices=("subprocess", "inproc"), default="subprocess",
                   help="subprocess = replica processes; inproc = the same wire "
                        "path in one process")
    c.add_argument("--device", default=None,
                   help="the replicas' device (default: the CUDA card; 'cpu' runs "
                        "the plain versions on the CPU)")
    c.add_argument("--state-dir", required=True)
    c.add_argument("--out", default=None, help="write the CAMPAIGN_*.json artifact here")
    c.add_argument("--quiet", action="store_true")
    return p


def _serve_main(args) -> int:
    try:
        check_range("replicas", args.replicas, 1, 64)
        check_range("port", args.port, 0, 65535)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    router_kw = dict(retry_max=args.retry_max, vnodes=args.vnodes,
                     breaker_fails=args.breaker_fails,
                     breaker_cooldown_s=args.breaker_cooldown_s, health_s=args.health_s,
                     proxy_timeout_s=args.proxy_timeout_s,
                     migrate_timeout_s=args.migrate_timeout_s)
    replicas = []
    try:
        for i in range(args.replicas):
            replicas.append(ReplicaProcess(
                f"r{i}", os.path.join(args.state_dir, f"r{i}"),
                serve_args=list(args.serve_args)).start())
        fleet = FleetManager(replicas, router_port=args.port, **router_kw)
    except (ReplicaError, ValueError, OSError) as e:
        for r in replicas:
            r.stop(timeout_s=10.0)
        print(f"[fleet] startup failed: {type(e).__name__}: {e}", flush=True)
        return 1
    print(f"[fleet] router listening on {fleet.base_url} ({args.replicas} replicas: "
          + ", ".join(r.base_url for r in replicas) + ")", flush=True)
    stop = threading.Event()

    def _signal(signum, _frame):
        print(f"[fleet] signal {signum}: stopping fleet", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _signal)
    signal.signal(signal.SIGINT, _signal)
    stop.wait()
    fleet.stop()
    print(f"[fleet] stopped: {args.replicas} replicas drained", flush=True)
    return 0


def _campaign_main(args) -> int:
    from traceweaver_tpu_torch.fleet_serve.campaign import run_fleet_campaign

    counts = tuple(int(x) for x in str(args.replicas).split(",") if x)
    try:
        artifact = run_fleet_campaign(
            state_root=args.state_dir, replica_counts=counts, tenants=args.tenants,
            seconds=args.seconds, traces_per_post=args.traces_per_post,
            base_period_s=args.base_period_s, mode=args.mode, out=args.out,
            verbose=not args.quiet, device=args.device)
    except (ReplicaError, RuntimeError) as e:
        print(f"[fleet-campaign] failed: {type(e).__name__}: {e}", flush=True)
        return 1
    if not args.quiet:
        from traceweaver_tpu_torch.campaign.compare import format_report

        print(format_report(artifact), flush=True)
    if args.out:
        print(f"[fleet-campaign] artifact: {args.out}", flush=True)
    return 0


def main(argv: List[str]) -> int:
    """``cli fleet``: a host process (the replicas own the card)."""
    args = _build_parser().parse_args(argv)
    if args.cmd == "serve":
        return _serve_main(args)
    return _campaign_main(args)
