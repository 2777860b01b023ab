"""Micro-batch scheduling of sealed windows onto the fleet solve path
(mirrors ``traceweaver_tpu/stream/scheduler.py``).

Sealed windows queue here and are solved in micro-batches: every window
of a batch contributes one
:class:`~traceweaver_tpu_torch.algorithms.fleet.FleetItem` per solvable
service, and the whole batch rides ONE
:func:`~traceweaver_tpu_torch.algorithms.fleet.solve_fleet` call, so
windows of similar geometry share a padded shape class and the card's
solves stay O(shape classes), not O(windows x services).

Backpressure is explicit and counted:

- at most ``max_pending`` sealed windows wait for the next micro-batch
  (the bound on in-flight device buffers);
- past it, windows shed to a spill queue of at most ``spill_max``
  (``shed_spilled``), solved later, oldest first: shed, not lost;
- past that, the offered window is dropped and its spans counted
  (``shed_dropped_windows`` / ``shed_dropped_spans``), the only lossy
  outcome.

Failure is explicit and counted too: each micro-batch solve runs under
an optional watchdog (``watchdog_s``: the solve runs on one worker
thread and the wait is bounded) and a bounded retry (``solve_retries``);
a batch that exhausts both goes to ``poison_fn``, the service's
dead-letter constructor, so it becomes counted poison windows, never a
lost micro-batch. Without a ``poison_fn`` the last error propagates.

On the card the watchdog's worker thread launches the kernels from a
thread of its own; ``solve_fleet``'s pipelined flows start their own
threads and CUDA streams under it, and each kernel launch sets its
shared-memory limit under the launch lock, as from any thread.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Deque, List, Optional

from traceweaver_tpu_torch.obs.registry import stream_families
from traceweaver_tpu_torch.runtime import faults
from traceweaver_tpu_torch.stream.window import WindowBuffer

# registry mirrors of the backpressure and watchdog outcomes (the
# scheduler's integer attributes keep their names: summaries and
# checkpoints read them)
_OBS_BACKPRESSURE = stream_families()["backpressure"]
_OBS_WATCHDOG = stream_families()["watchdog"]


class SolveTimeout(RuntimeError):
    """A micro-batch solve exceeded the watchdog timeout. Classified as
    transient (a hung device dispatch is exactly what the retry exists
    for); the hung attempt's thread is abandoned, not interrupted —
    device work cannot be cancelled — and its eventual result is
    discarded."""


class MicroBatchScheduler:
    """Bounded queue + spill in front of a window-batch solve function.

    ``solve_fn(batch: List[WindowBuffer]) -> List[result]`` solves a
    micro-batch of sealed windows and returns one result per window, in
    order. The scheduler owns no solver state itself, so checkpointing
    only needs its two queues (the watchdog/retry counters ride the
    service's stats dict).
    """

    def __init__(self, solve_fn: Callable[[List[WindowBuffer]], List],
                 max_pending: int = 4, spill_max: int = 64,
                 watchdog_s: Optional[float] = None,
                 solve_retries: int = 1,
                 poison_fn: Optional[Callable] = None) -> None:
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.solve_fn = solve_fn
        self.max_pending = int(max_pending)
        self.spill_max = int(spill_max)
        self.watchdog_s = watchdog_s
        self.solve_retries = max(0, int(solve_retries))
        self.poison_fn = poison_fn
        self.pending: Deque[WindowBuffer] = deque()
        self.spill: Deque[WindowBuffer] = deque()
        self.shed_spilled = 0
        self.shed_dropped_windows = 0
        self.shed_dropped_spans = 0
        self.solved_windows = 0
        self.solve_timeouts = 0
        self.solve_retried = 0
        self.poisoned_windows = 0
        self._watchdog_pool: Optional[ThreadPoolExecutor] = None

    # -- producer side ----------------------------------------------------
    def offer(self, buf: WindowBuffer) -> str:
        """Enqueue one sealed window. Returns "queued", "spilled", or
        "dropped"."""
        if len(self.pending) < self.max_pending:
            self.pending.append(buf)
            _OBS_BACKPRESSURE.inc(outcome="queued")
            return "queued"
        if len(self.spill) < self.spill_max:
            self.spill.append(buf)
            self.shed_spilled += 1
            _OBS_BACKPRESSURE.inc(outcome="spilled")
            return "spilled"
        self.shed_dropped_windows += 1
        self.shed_dropped_spans += buf.n_spans
        _OBS_BACKPRESSURE.inc(outcome="dropped")
        return "dropped"

    @property
    def backlog(self) -> int:
        return len(self.pending) + len(self.spill)

    def pop_batch(self) -> List[WindowBuffer]:
        """Take the next micro-batch off the queues: refill pending from
        spill (oldest first) up to the pending bound, then hand the whole
        pending queue over."""
        while self.spill and len(self.pending) < self.max_pending:
            self.pending.append(self.spill.popleft())
        batch = list(self.pending)
        self.pending.clear()
        return batch

    def ready(self) -> List[WindowBuffer]:
        """Sealed windows awaiting solve, oldest first (pending then
        spill)."""
        return list(self.pending) + list(self.spill)

    # -- consumer side ----------------------------------------------------
    def take(self, bufs: List[WindowBuffer]) -> List[WindowBuffer]:
        """Remove exactly the given buffers from the queues (identity
        match) and return them in the given order: the serve tier's
        admission takes the windows it picked from :meth:`ready`. Buffers
        no longer queued (drained by a concurrent flush) are skipped, so
        admission races solve a window at most once."""
        chosen = {id(b): k for k, b in enumerate(bufs)}
        taken: List[WindowBuffer] = []
        for q in (self.pending, self.spill):
            kept = [b for b in q if id(b) not in chosen]
            taken.extend(b for b in q if id(b) in chosen)
            q.clear()
            q.extend(kept)
        taken.sort(key=lambda b: chosen[id(b)])
        return taken

    def _solve_once(self, batch: List[WindowBuffer]) -> List:
        """One solve attempt, under the watchdog when configured. The
        watchdog runs the solve on a single persistent worker thread and
        bounds the WAIT — a timed-out solve keeps running detached (its
        thread is not interruptible) and its late result is dropped."""
        if not self.watchdog_s:
            return self.solve_fn(batch)
        if self._watchdog_pool is None:
            self._watchdog_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tw-stream-watchdog")
        fut = self._watchdog_pool.submit(self.solve_fn, batch)
        try:
            return fut.result(timeout=self.watchdog_s)
        except FutureTimeout:
            self.solve_timeouts += 1
            _OBS_WATCHDOG.inc(outcome="timeout")
            fut.cancel()  # best effort; a running solve is abandoned
            # a hung worker would serialize behind the abandoned solve:
            # detach the pool so the retry gets a fresh thread
            self._watchdog_pool = None
            raise SolveTimeout(
                f"micro-batch solve of {len(batch)} window(s) exceeded "
                f"the {self.watchdog_s:.1f}s watchdog") from None

    def _solve_guarded(self, batch: List[WindowBuffer]) -> List:
        """Watchdog + bounded retry + poison hand-off for one batch."""
        err: Optional[BaseException] = None
        for attempt in range(1 + self.solve_retries):
            if attempt:
                self.solve_retried += 1
                _OBS_WATCHDOG.inc(outcome="retried")
            try:
                return self._solve_once(batch)
            except SolveTimeout as e:
                err = e
            except Exception as e:  # noqa: BLE001 — classified below
                if not faults.is_transient_fault(e):
                    raise
                err = e
        self.poisoned_windows += len(batch)
        _OBS_WATCHDOG.inc(len(batch), outcome="poisoned")
        if self.poison_fn is not None:
            return self.poison_fn(batch, err)
        raise err

    def pump(self, max_batches: Optional[int] = None) -> List:
        """Solve queued windows in micro-batches of ``max_pending``,
        refilling from the spill queue between batches, until the backlog
        is empty (or ``max_batches`` batches have run — the throttle used
        to model a slow consumer). Returns the solved results in
        submission order."""
        results: List = []
        batches = 0
        while self.pending or self.spill:
            if max_batches is not None and batches >= max_batches:
                break
            batch = self.pop_batch()
            out = self._solve_guarded(batch)
            if len(out) != len(batch):
                raise RuntimeError(
                    f"solve_fn returned {len(out)} results for a "
                    f"{len(batch)}-window batch")
            results.extend(out)
            self.solved_windows += len(batch)
            batches += 1
        return results

    def close(self) -> None:
        if self._watchdog_pool is not None:
            self._watchdog_pool.shutdown(wait=False)
            self._watchdog_pool = None
