"""Replica fleet lifecycle: spawn, watch, migrate, rolling restart
(mirrors ``traceweaver_tpu/fleet_serve/manager.py``).

Two replica kinds behind one surface (``name``, ``base_url``, ``stop()``):

- :class:`ReplicaProcess`: one ``python -m
  traceweaver_tpu_torch.runtime.cli serve`` subprocess a replica, sharing
  nothing (its own state dir, its own interpreter, its own CUDA context),
  its port parsed from its ``[serve] listening on http://HOST:PORT``
  line. It runs on the card unless its ``serve_args`` hold ``--device
  cpu``: the JAX package's replicas are forced onto the CPU, the port's
  are not. With no card and no ``--device`` the replica exits 2 and
  :meth:`ReplicaProcess.start` raises :class:`ReplicaError`; there is no
  fallback to the CPU. A cold start pays a torch import, a CUDA context
  and the loading of the kernel libraries from ``_build/`` (two replicas
  starting on a fresh tree may both run ``nvcc``; ``ops/cuda_build.py``
  writes through a temporary file per process and renames, so the race
  is safe), so ``startup_timeout_s`` covers that.
- :class:`InProcReplica`: a whole
  :class:`~traceweaver_tpu_torch.serve.TenantService` behind a real HTTP
  server in this process: the same wire path without a spawn, for tests.

:class:`FleetManager` composes N replicas with a
:class:`~traceweaver_tpu_torch.fleet_serve.router.FleetRouter` and owns
the fleet-wide operations:

- ``migrate(tenant, dst)``: the router's hold, out, in, pin, commit (an
  abort on the source when the destination refuses);
- ``rolling_restart()``: one replica at a time, its tenants migrated to
  the survivors, the replica out of routing before its SIGTERM (serve
  checkpoints every tenant left), a respawn with ``--resume``, routing
  restored once its ``/readyz`` answers 200.

With ``supervise=True`` a watcher thread polls each subprocess replica's
liveness, and a replica that exits unasked (SIGKILL, a crash: anything
not marked draining) is recovered one of two ways, the recovery wall
recorded in ``tw_failover_seconds{mode=...}``:

- **a counted respawn** (fewer than ``respawn_max`` so far): a doubling
  backoff, then ``--resume`` on the same state dir; the checkpoints give
  back the windows and the WAL replays every acknowledged POST after
  them. The replica's tenants are held at the router meanwhile; a POST
  held past the router's ``migrate_timeout_s`` is answered 503.
- **survivor failover** (the budget spent, a survivor left): each tenant
  on the dead disk is rebuilt from its checkpoint (``.prev`` if the
  primary tore) and WAL tail
  (:func:`~traceweaver_tpu_torch.serve.tenancy.read_crashed_transfer`),
  ``migrate_in``'d on the least-loaded survivor, pinned there and
  tombstoned on the dead disk.

The JAX package's ``TW_FLEET_RESPAWN_MAX`` is ``respawn_max`` (default
3, range [0, 64]); the router's knobs pass through ``router_kw``.
"""

from __future__ import annotations

import contextlib
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from traceweaver_tpu_torch.fleet_serve.router import FleetRouter, check_range, http_json
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry

_LISTEN_RE = re.compile(r"listening on (http://[\d.]+:\d+)")
#: the directory that holds the ``traceweaver_tpu_torch`` package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: ``TW_FLEET_RESPAWN_MAX``'s default
RESPAWN_MAX = 3

_OBS_FAILOVER = _get_registry().histogram(
    "tw_failover_seconds",
    "wall-clock seconds from replica-crash detection to restored routing, by "
    "recovery mode (respawn/failover)",
    labels=("mode",))


class ReplicaError(RuntimeError):
    """A replica process failed to start, stop or come back ready."""


def _child_env(env: Optional[Dict[str, str]]) -> Dict[str, str]:
    """The replica's environment: the caller's (or this process's), with
    the port's root on ``PYTHONPATH`` so ``-m`` finds the package from any
    working directory."""
    out = dict(os.environ if env is None else env)
    path = out.get("PYTHONPATH", "")
    if _ROOT not in path.split(os.pathsep):
        out["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    return out


class ReplicaProcess:
    """One ``cli serve`` subprocess: spawn, parse the listen line, tail its
    output on a thread (kept in ``self.log`` for post-mortems), SIGTERM
    stop, respawn with ``--resume``."""

    def __init__(self, name: str, state_dir: str, serve_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 startup_timeout_s: float = 180.0) -> None:
        self.name = name
        self.state_dir = state_dir
        self.serve_args = list(serve_args or [])
        self.env = _child_env(env)
        self.startup_timeout_s = startup_timeout_s
        self.base_url = ""
        self.log: List[str] = []
        self.restarts = 0
        self.proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._listen = threading.Event()

    def start(self, resume: bool = False) -> "ReplicaProcess":
        if self.proc is not None and self.proc.poll() is None:
            raise ReplicaError(f"replica {self.name} already running")
        cmd = [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "serve",
               "--port", "0", "--state-dir", self.state_dir]
        if resume:
            cmd.append("--resume")
        cmd += self.serve_args
        self._listen.clear()
        self.proc = subprocess.Popen(cmd, env=self.env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._tail, name=f"tw-replica-{self.name}-log",
                                        daemon=True)
        self._reader.start()
        if not self._listen.wait(timeout=self.startup_timeout_s) or not self.base_url:
            tail = "\n".join(self.log[-20:])
            self.stop(timeout_s=5.0)
            raise ReplicaError(
                f"replica {self.name} never printed its listen line within "
                f"{self.startup_timeout_s:.0f}s (exit {self.proc.returncode}); "
                f"log tail:\n{tail}")
        return self

    def _tail(self) -> None:
        proc = self.proc
        assert proc is not None and proc.stdout is not None
        for line in proc.stdout:
            self.log.append(line.rstrip("\n"))
            m = _LISTEN_RE.search(line)
            if m:
                self.base_url = m.group(1)
                self._listen.set()
        # end of output: the process exited; one that died before
        # listening releases start() at once, which reports its log
        self._listen.set()

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, timeout_s: float = 120.0) -> None:
        """SIGTERM (serve drains: checkpoints every tenant), wait; SIGKILL
        only past the drain budget."""
        proc = self.proc
        if proc is None:
            return
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        if self._reader is not None:
            self._reader.join(timeout=5.0)

    def restart(self, timeout_s: float = 120.0) -> str:
        """Graceful stop and a ``--resume`` respawn; returns the new base
        url (port 0: the port changes, the caller re-points the router)."""
        self.stop(timeout_s=timeout_s)
        self.base_url = ""
        self.start(resume=True)
        self.restarts += 1
        return self.base_url


class InProcReplica:
    """A whole serve replica (``TenantService`` behind the threaded HTTP
    server) in this process: the real wire path without a subprocess."""

    def __init__(self, name: str, cfg, device=None) -> None:
        # imported here: the fleet's own process stays torch-free until a
        # replica is built in it
        from traceweaver_tpu_torch.serve import TenantService, make_server

        self.name = name
        self.service = TenantService(cfg, device=device)
        self.server = make_server(self.service, host="127.0.0.1", port=0)
        self.base_url = f"http://127.0.0.1:{self.server.port}"
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name=f"tw-replica-{name}", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 30.0) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=timeout_s)
        self.service.drain()


class FleetManager:
    """N replicas and one router, started together, stopped together.

    ``supervise=True`` arms the crash supervisor (subprocess replicas
    only): unasked exits are seen within ``watch_period_s`` and recovered
    by a counted respawn or a survivor failover (see the module
    docstring)."""

    def __init__(self, replicas: List, router_port: int = 0, verbose: bool = False,
                 supervise: bool = False, watch_period_s: float = 0.2,
                 respawn_max: int = RESPAWN_MAX, **router_kw) -> None:
        self.respawn_max = check_range("respawn_max", int(respawn_max), 0, 64)
        self.replicas: Dict[str, object] = {r.name: r for r in replicas}
        self.router = FleetRouter({r.name: r.base_url for r in replicas},
                                  port=router_port, verbose=verbose, **router_kw).start()
        self.verbose = verbose
        self.respawns: Dict[str, int] = {}
        self.failovers: List[Dict[str, object]] = []
        self.recoveries: List[Dict[str, object]] = []
        self._watch_period_s = watch_period_s
        self._stop_ev = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if supervise:
            # failed proxy attempts yield one grace period, so crash
            # detection and tenant holds beat the retry to the ring
            self.router.crash_grace_s = max(0.5, 3.0 * watch_period_s)
            self._watcher = threading.Thread(target=self._watch_loop,
                                             name="tw-fleet-supervisor", daemon=True)
            self._watcher.start()

    @property
    def base_url(self) -> str:
        return self.router.base_url

    def migrate(self, tenant: str, dst: str) -> Dict[str, object]:
        return self.router.migrate(tenant, dst)

    def replica_tenants(self, name: str) -> List[str]:
        ref = self.router.replicas[name]
        status, out = http_json("GET", ref.base_url + "/api/v1/tenants",
                                timeout=self.router.proxy_timeout_s)
        if status != 200:
            raise ReplicaError(f"replica {name}: /api/v1/tenants HTTP {status}")
        return list(out.get("tenants", []))

    def _drain_target(self, exclude: str, timeout_s: float = 60.0) -> str:
        """The destination for a leaving replica's tenants: the routable
        survivor with the fewest tenants. A survivor may be out of routing
        for a moment (a health probe that timed out while it was busy, a
        breaker cooling down), so one is waited for up to ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            best, best_n = None, None
            for name, ref in self.router.replicas.items():
                if name == exclude or not ref.routable:
                    continue
                n = len(self.replica_tenants(name))
                if best_n is None or n < best_n:
                    best, best_n = name, n
            if best is not None:
                return best
            if time.monotonic() > deadline:
                raise ReplicaError(f"{exclude}: no routable survivor to move its "
                                   f"tenants to within {timeout_s:.0f}s")
            time.sleep(0.2)

    def rolling_restart(self, ready_timeout_s: float = 180.0) -> Dict[str, object]:
        """Restart every replica, one at a time, losing no request: its
        tenants migrate off first, it leaves routing before its SIGTERM,
        and the next replica's turn waits for ``/readyz`` to answer 200
        from the respawned process."""
        report: Dict[str, object] = {}
        for name in sorted(self.replicas):
            rep = self.replicas[name]
            if not isinstance(rep, ReplicaProcess):
                raise ReplicaError(f"rolling restart needs subprocess replicas; "
                                   f"{name} is {type(rep).__name__}")
            moved = []
            for tenant in self.replica_tenants(name):
                dst = self._drain_target(exclude=name)
                self.migrate(tenant, dst)
                moved.append((tenant, dst))
            # out of rotation before the kill: no POST races the teardown
            self.router.set_draining(name, True)
            try:
                new_url = rep.restart()
                self.router.update_replica(name, new_url)
                self._wait_ready(name, timeout_s=ready_timeout_s)
            finally:
                self.router.set_draining(name, False)
            self.router.bump("restarts")
            _events.emit("fleet", "rolling_restart", replica=name, moved=len(moved),
                         new_url=new_url)
            report[name] = dict(moved=moved, base_url=new_url)
        return report

    def _wait_ready(self, name: str, timeout_s: float) -> None:
        ref = self.router.replicas[name]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                status, _ = http_json("GET", ref.base_url + "/readyz", timeout=5.0)
            except OSError:
                status = None
            if status == 200:
                ref.ready = True
                return
            time.sleep(0.2)
        raise ReplicaError(f"replica {name} did not become ready within "
                           f"{timeout_s:.0f}s after restart")

    # -- the crash supervisor ---------------------------------------------
    def _watch_loop(self) -> None:
        """Liveness poll over the subprocess replicas. One dead but not
        draining (nobody asked it to stop) crashed, and is recovered. The
        loop never dies: a failed recovery is evented and the replica
        struck from further attempts."""
        gave_up: set = set()
        while not self._stop_ev.wait(self._watch_period_s):
            for name, rep in sorted(self.replicas.items()):
                if not isinstance(rep, ReplicaProcess) or name in gave_up:
                    continue
                ref = self.router.replicas.get(name)
                if rep.alive or ref is None or ref.draining:
                    continue
                if self._stop_ev.is_set():
                    return
                try:
                    done = self._recover_crashed(name, rep)
                except Exception as e:  # noqa: BLE001 — the supervisor survives
                    done = True
                    _events.emit("fleet", "recover_failed", replica=name,
                                 error=f"{type(e).__name__}: {e}")
                if done:
                    gave_up.add(name)

    def _crashed_tenant_dirs(self, rep: ReplicaProcess) -> List[str]:
        """Tenant ids with recoverable state on a crashed replica's disk
        (``TenantService.resume``'s scan: a checkpoint or a WAL, and no
        migration tombstone)."""
        out: List[str] = []
        try:
            names = sorted(os.listdir(rep.state_dir))
        except OSError:
            return out
        for n in names:
            tdir = os.path.join(rep.state_dir, n)
            if not os.path.isdir(tdir):
                continue
            if os.path.isfile(os.path.join(tdir, "migrated_out.json")):
                continue
            if (os.path.isfile(os.path.join(tdir, "ckpt.pkl"))
                    or os.path.isfile(os.path.join(tdir, "ckpt.pkl.prev"))
                    or os.path.isdir(os.path.join(tdir, "wal"))):
                out.append(n)
        return out

    def _recover_crashed(self, name: str, rep: ReplicaProcess) -> bool:
        """One recovery round. True when the supervisor is done with the
        replica (failover ran, nothing left to try); False keeps it under
        watch (a respawned process may crash again)."""
        t0 = time.monotonic()
        rc = rep.proc.returncode if rep.proc is not None else None
        ref = self.router.replicas[name]
        tenants = self._crashed_tenant_dirs(rep)
        _events.emit("fleet", "replica_crashed", replica=name, returncode=rc,
                     tenants=len(tenants), respawns_used=self.respawns.get(name, 0))
        # the dead replica's tenants wait at the router during recovery,
        # rather than minting empty twins on a survivor: held before the
        # replica leaves routing, so no retry finds it gone and them free
        with contextlib.ExitStack() as stack:
            for t in tenants:
                stack.enter_context(self.router.hold_tenant(t))
            ref.ready = False  # out of routing before the health loop notices
            n = self.respawns.get(name, 0)
            if n < self.respawn_max:
                self.respawns[name] = n + 1
                self._respawn_crashed(name, rep, backoff_round=n, t0=t0)
                return False
            self._failover_crashed(name, rep, tenants, t0=t0)
        return True

    def _respawn_crashed(self, name: str, rep: ReplicaProcess, backoff_round: int,
                         t0: float) -> None:
        """Respawn in place: a doubling backoff, then ``--resume`` on the
        same state dir (the checkpoints, then the WAL tail)."""
        self._stop_ev.wait(min(5.0, 0.25 * (2 ** backoff_round)))
        if self._stop_ev.is_set():
            return
        if rep._reader is not None:
            rep._reader.join(timeout=5.0)
        rep.base_url = ""
        rep.start(resume=True)
        rep.restarts += 1
        self.router.update_replica(name, rep.base_url)
        self._wait_ready(name, timeout_s=rep.startup_timeout_s)
        wall_s = time.monotonic() - t0
        _OBS_FAILOVER.observe(wall_s, mode="respawn")
        self.recoveries.append(dict(replica=name, mode="respawn", wall_s=wall_s))
        self.router.bump("respawns")
        _events.emit("fleet", "replica_respawned", replica=name, new_url=rep.base_url,
                     wall_s=round(wall_s, 3), respawns_used=self.respawns.get(name, 0))

    def _failover_crashed(self, name: str, rep: ReplicaProcess, tenants: List[str],
                          t0: float) -> None:
        """The respawn budget spent: rebuild each tenant from the dead disk
        (checkpoint and WAL tail) on the least-loaded survivor, pin it
        there, tombstone the dead copy."""
        # imported here: the manager's process stays torch-free until a
        # failover runs
        from traceweaver_tpu_torch.serve import tenancy as _tenancy

        moved, skipped = [], []
        for tenant in tenants:
            tdir = os.path.join(rep.state_dir, tenant)
            dst = self._drain_target(exclude=name)
            try:
                payload = _tenancy.read_crashed_transfer(tdir, tenant)
            except _tenancy.TenancyError as e:
                # nothing recoverable (no checkpoint yet, an empty WAL): no
                # acknowledged state to lose
                skipped.append(tenant)
                _events.emit("fleet", "crash_failover_skipped", replica=name,
                             tenant=tenant, error=str(e))
                continue
            dst_url = self.router.replicas[dst].base_url
            status, res = http_json("POST", f"{dst_url}/api/v1/tenants/{tenant}/migrate_in",
                                    payload, timeout=self.router.migrate_timeout_s)
            if status != 200:
                raise ReplicaError(f"crash failover of {tenant!r} onto {dst}: HTTP {status} "
                                   f"{res.get('error', '')}: its state stays on {name}'s "
                                   f"disk ({tdir})")
            self.router.pin(tenant, dst)
            _tenancy.tombstone_crashed_tenant(tdir, tenant)
            moved.append((tenant, dst))
        wall_s = time.monotonic() - t0
        _OBS_FAILOVER.observe(wall_s, mode="failover")
        self.router.bump("failovers")
        self.failovers.append(dict(replica=name, moved=moved, skipped=skipped,
                                   wall_s=round(wall_s, 3)))
        self.recoveries.append(dict(replica=name, mode="failover", wall_s=wall_s))
        _events.emit("fleet", "crash_failover", replica=name, moved=len(moved),
                     skipped=len(skipped), wall_s=round(wall_s, 3))

    def stop(self) -> None:
        # the supervisor first: the teardown below stops replicas on
        # purpose, and a live watcher would "recover" them
        self._stop_ev.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10.0)
        self.router.stop()
        for rep in self.replicas.values():
            rep.stop()  # type: ignore[attr-defined]
