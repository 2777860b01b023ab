"""Device-resident span columns: ring buffers on the device and window
assembly by gathers (mirrors ``traceweaver_tpu/ops/devcols.py``).

The columnar host packer fills the dense ``[B, W]`` / ``[B, E, M]``
window tensors in host memory and ships them on every dispatch, so on
the stream and in serving, where overlapping windows and repeated solves
reference the same spans again and again, the same columns cross to the
device again and again. This module keeps them resident instead
(``solve_fleet(devcols=True)``, the default, as ``TW_DEVCOLS`` is in the
JAX package):

- :class:`ColumnRing`, one per (tenant, service, partition kind: "in"
  server spans, "out" client spans) and device, is a circular ``[cap,
  3]`` int32 device tensor of span columns (start and end microseconds
  relative to the ring's epoch, and the endpoint id). An append writes
  only the new rows, in place (``buf[start:start + n].copy_(rows)``); a
  span already resident ships zero bytes on every later dispatch that
  references it. The capacity (``ring_capacity``, ``TW_DEVCOLS_RING``)
  must exceed the in-flight working set: appends past it evict oldest
  first. The occupancy gauge ``tw_devcols_ring_fill`` is the pressure
  signal.
- :func:`assemble_windows` builds the six window tensors from the rings
  and small host-computed index arrays by gathers: clamp the index,
  gather ``[b, W, 3]`` and ``[b, E, M, 3]``, subtract the window origin
  in int32, then convert to f32. It is an XLA-fused gather in the JAX
  package, no Pallas kernel, so plain tensor operations are its port.

Exactness: the host packer computes ``float32(float64(t) -
float64(origin))``, the gathers ``float32(int32(t - epoch) - int32(origin
- epoch))``. The two are bit-identical whenever every timestamp is an
integral number of microseconds and the window-relative offsets fit
int32, both checked per resolve; a partition that fails either check
sends its whole dispatch group to the host packer, counted in
``devcols_fallbacks``.

Ordering across CUDA streams: the JAX package donates the ring buffer to
each append and its runtime orders the in-place write after pending
readers. PyTorch gives no such order across streams, and the fleet
appends from its pack thread while its flow workers gather on streams of
their own. So each ring records a CUDA event after every append and
every gather: a gather first waits for the last append (it must read
what the resolve just wrote), and an append first waits for every
gather recorded since the previous append (it must not overwrite slots
a queued gather has not read). Both run under the ring's lock, and a
group's gather takes the two rings' locks in the JAX order, in before
out.

Where the port parts from the JAX package, and why:

- The JAX package keeps one global arena per partition kind, so that a
  whole dispatch group assembles in one jitted gather and its compiled
  shapes stay few. The port compiles nothing, so it keeps one ring per
  (tenant, service, partition kind), as the registry's signature
  suggests, and a group gathers item by item: one tenant's traffic
  never evicts another's columns, and a tenant's ring contents do not
  depend on what its neighbours post.
- Appends are not padded to powers of two (the JAX package pads them for
  its compiled shapes), so no slot is spent on padding.
- The first epoch sits ``EPOCH_SLACK`` µs before the first span, so an
  earlier window resolved after a later one (another group, another
  ticket) does not force a re-epoch.
- An index array is only as good as the slots it names. Each resolve
  returns the lowest sequence it references; a group whose later items'
  appends evicted an earlier item's slots packs on the host instead, and
  a gather first checks, under the ring's lock, that its slots are
  still live (:func:`assemble_resident` returns None when not: the
  fleet then packs that group on the host, counted in
  ``devcols_fallbacks``). Once enqueued, a gather is safe from later
  appends by the cross-stream order above. The JAX package gathers
  whatever the slots hold.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from traceweaver_tpu_torch.obs.registry import serve_families
from traceweaver_tpu_torch.runtime.bucketing import pow2_bucket
from traceweaver_tpu_torch.spans import SpanArray

# a window origin can sit this far (µs) from the ring epoch before the
# int32 relative representation overflows; past it the ring re-epochs
# (full re-append, counted), about 35 minutes of stream time an epoch
_INT32_SPAN = (1 << 31) - 1

#: ``TW_DEVCOLS_RING``: slots of one ring
RING_CAPACITY = 1 << 15
#: how far (µs) before its first span a ring's first epoch sits
EPOCH_SLACK = float(1 << 29)
# the lowest sequence of a resolve that references nothing
_NO_SEQ = np.iinfo(np.int64).max

_OBS = serve_families()
_OBS_RING_FILL = _OBS["ring_fill"]
_OBS_RING_EVENTS = _OBS["ring_events"]


def assemble_windows(in_buf: torch.Tensor, out_buf: torch.Tensor,
                     in_idx: torch.Tensor, out_idx: torch.Tensor,
                     origin_in: torch.Tensor, origin_out: torch.Tensor):
    """The six window tensors of ``pack_problem`` from the ring buffers.

    ``in_buf``/``out_buf`` are ``[cap, 3]`` int32 rings (relative start,
    relative end, endpoint id); ``in_idx [b, W]`` and ``out_idx [b, E,
    M]`` are int32 ring slots (-1: no span); ``origin_in``/``origin_out``
    ``[b]`` are each window's origin relative to the ring's epoch. The
    origin is subtracted in int32 and only the difference converts to
    f32 (round to nearest even), so the result equals the host packer's
    bit for bit on integral-µs timestamps."""
    iv = in_idx >= 0
    g = in_buf[in_idx.clamp(0, in_buf.shape[0] - 1).long()]          # [b, W, 3]
    rel_in = origin_in[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=in_buf.device)
    in_start = torch.where(iv, (g[..., 0] - rel_in).to(torch.float32), zero)
    in_end = torch.where(iv, (g[..., 1] - rel_in).to(torch.float32), zero)
    ov = out_idx >= 0
    h = out_buf[out_idx.clamp(0, out_buf.shape[0] - 1).long()]       # [b, E, M, 3]
    rel_out = origin_out[:, None, None]
    out_start = torch.where(ov, (h[..., 0] - rel_out).to(torch.float32), zero)
    out_end = torch.where(ov, (h[..., 1] - rel_out).to(torch.float32), zero)
    return in_start, in_end, iv, out_start, out_end, ov


def assemble_resident(ring_in: "ColumnRing", ring_out: "ColumnRing",
                      in_idx: np.ndarray, out_idx: np.ndarray,
                      origin_in: np.ndarray, origin_out: np.ndarray,
                      live: Tuple[int, int] = (0, 0)):
    """:func:`assemble_windows` on the rings' buffers, on the caller's
    current stream, under both rings' locks (in before out): the index
    arrays are placed, the stream waits for each ring's last append, the
    gathers are enqueued and an event is recorded on each ring for its
    next append to wait on. ``live`` is the lowest sequence the index
    arrays reference in each ring (from :meth:`ColumnRing.resolve`);
    when either was evicted since, nothing is gathered and None is
    returned."""
    with ring_in._lock:
        with ring_out._lock:
            if live[0] < ring_in.evict_seq or live[1] < ring_out.evict_seq:
                _OBS_RING_EVENTS.inc(kind="stale_gather")
                return None
            dev = ring_in.buf.device
            ring_in._before_read()
            ring_out._before_read()
            args = [torch.as_tensor(a, device=dev)
                    for a in (in_idx, out_idx, origin_in, origin_out)]
            outs = assemble_windows(ring_in.buf, ring_out.buf, *args)
            ring_in._after_read()
            ring_out._after_read()
            return outs


def fetch_resident(handle: torch.Tensor, ledger=None) -> np.ndarray:
    """The one billed host copy of ring-resident device data (a ring
    buffer, assembled window tensors): a real device-to-host transfer,
    billed to ``d2h_bytes_resident``."""
    out = handle.cpu().numpy()
    if ledger is not None:
        ledger("d2h_bytes_resident", float(out.nbytes))
    return out


class ColumnRing:
    """One partition kind's device-resident column ring and its host
    mirror.

    The device side is ``buf`` (``[cap, 3]`` int32, written in place).
    The host side keeps what correctness needs and the device cannot
    answer without a fetch: the id → sequence map, the float64
    start/end mirror (a resolved id re-appends when another corpus
    reuses it with other times: ids are unique per corpus only), the
    endpoint-id mirror (with start and end a complete copy of every live
    slot, which is what :meth:`rebuild` restores from) and the eviction
    horizon (padded appends clobber slots ahead of the write head; those
    sequences are dead and re-append on their next use).

    :meth:`resolve` is the only write path and holds the ring's lock:
    the supervisor's bisection re-packs on flow workers while the
    pipeline's pack thread packs."""

    __slots__ = ("key", "cap", "device", "buf", "epoch", "next_seq", "evict_seq",
                 "slot_of", "host_start", "host_end", "host_ep",
                 "appended_rows", "appended_bytes", "rebuilds",
                 "_ep_table", "_lock", "_written", "_reads")

    def __init__(self, key: str, cap: Optional[int] = None, device="cpu") -> None:
        self.key = key
        self.cap = pow2_bucket(int(cap or RING_CAPACITY))
        self.device = torch.device(device)
        self.buf = torch.zeros((self.cap, 3), dtype=torch.int32, device=self.device)
        self.epoch: Optional[float] = None
        self.next_seq = 0           # total rows ever appended
        self.evict_seq = 0          # sequences below this are dead
        self.slot_of: Dict[Tuple, int] = {}
        self.host_start = np.zeros(self.cap, dtype=np.float64)
        self.host_end = np.zeros(self.cap, dtype=np.float64)
        self.host_ep = np.full(self.cap, -1, dtype=np.int32)
        self.appended_rows = 0
        self.appended_bytes = 0
        self.rebuilds = 0
        self._ep_table: Dict[str, int] = {}
        self._lock = threading.Lock()
        # the last append's event, and the gathers' events since it (the
        # cross-stream order the JAX runtime gives donation for free)
        self._written: Optional[torch.cuda.Event] = None
        self._reads: List[torch.cuda.Event] = []

    # -- cross-stream order (caller holds the lock) -----------------------
    def _before_read(self) -> None:
        if self._written is not None:
            torch.cuda.current_stream(self.device).wait_event(self._written)

    def _after_read(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._reads.append(ev)

    def _write(self, start: int, rows: np.ndarray) -> None:
        """In-place write of ``rows`` at slot ``start``, ordered after
        every gather recorded since the last write."""
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for ev in self._reads:
                stream.wait_event(ev)
            self._reads.clear()
        self.buf[start:start + rows.shape[0]].copy_(torch.from_numpy(rows))
        if self.device.type == "cuda":
            self._written = torch.cuda.Event()
            self._written.record(torch.cuda.current_stream(self.device))

    # -- eligibility ------------------------------------------------------
    @staticmethod
    def _integral(col: np.ndarray) -> bool:
        return bool(np.all(np.isfinite(col)) and np.all(col == np.floor(col)))

    def _eligible(self, cols: SpanArray) -> bool:
        if len(cols) == 0:
            return True
        if not (self._integral(cols.start) and self._integral(cols.end)):
            return False
        if self.epoch is not None:
            lo = float(np.min(cols.start))
            hi = float(np.max(cols.end))
            if not (0 <= lo - self.epoch and hi - self.epoch < _INT32_SPAN):
                # past the int32 window: re-epoch (every resident entry
                # dies; the next resolve re-appends)
                self._reset(epoch=lo - EPOCH_SLACK)
                _OBS_RING_EVENTS.inc(kind="re_epoch")
        return True

    def _reset(self, epoch: Optional[float]) -> None:
        self.epoch = epoch
        self.evict_seq = self.next_seq
        self.slot_of.clear()

    # -- the one write and read path --------------------------------------
    def resolve(self, cols: SpanArray, endpoint: Optional[str] = None,
                ledger=None, scope=None) -> Optional[Tuple[np.ndarray, int]]:
        """Map a sorted partition's spans to live ring slots, appending
        what is not resident yet. Returns ``(slots, seq)``: int32 ``[n]``
        slots and the lowest sequence they name (the liveness floor
        :func:`assemble_resident` checks), or None when the partition
        cannot ride the resident path (non-integral timestamps, or more
        live spans than the ring holds): the caller then packs on the
        host, counted.

        ``scope`` namespaces the id → slot map (the fleet passes
        ``(tenant, service)``): span ids are unique per corpus only, and
        two scopes reusing an id with other times must not evict each
        other on every resolve."""
        with self._lock:
            return self._resolve_locked(cols, endpoint, ledger, scope)

    def is_live(self, seq: int) -> bool:
        """Is sequence ``seq`` (and every later one) still resident?"""
        with self._lock:
            return seq >= self.evict_seq

    def _resolve_locked(self, cols, endpoint, ledger, scope):
        n = len(cols)
        if not self._eligible(cols):
            _OBS_RING_EVENTS.inc(kind="ineligible")
            return None
        if n == 0:
            return np.zeros(0, dtype=np.int32), _NO_SEQ
        if self.epoch is None:
            self.epoch = float(np.min(cols.start)) - EPOCH_SLACK

        seqs = np.fromiter((self.slot_of.get((scope, i), -1) for i in cols.ids),
                           dtype=np.int64, count=n)
        # value check: the same id with other times is another corpus
        # reusing the id space, re-appended, never aliased
        live = seqs >= self.evict_seq
        slots = (seqs % self.cap).astype(np.int64)
        match = live.copy()
        if match.any():
            m = match.nonzero()[0]
            match[m] = ((self.host_start[slots[m]] == cols.start[m])
                        & (self.host_end[slots[m]] == cols.end[m]))
        missing = ~match

        # eviction fixpoint: appending l_pad rows (perhaps skipping to
        # slot 0 at the wrap) moves the eviction horizon, which can strand
        # more live rows of this very batch; they join the append before
        # its size is final
        for _ in range(64):
            l_pad = int(missing.sum())
            if l_pad > self.cap:
                _OBS_RING_EVENTS.inc(kind="ineligible")
                return None
            start_slot = self.next_seq % self.cap
            skip = (self.cap - start_slot) if start_slot + l_pad > self.cap else 0
            horizon = self.next_seq + skip + l_pad - self.cap
            grew = match & (seqs < horizon)
            if not grew.any():
                break
            match &= ~grew
            missing |= grew
        else:  # pragma: no cover - bounded by the capacity's doublings
            return None
        if not missing.any():
            self._observe()
            return slots.astype(np.int32), int(seqs.min())

        # one contiguous write; at the wrap it skips to slot 0 with the
        # gap marked evicted
        mi = missing.nonzero()[0]
        n_new = int(mi.size)
        l_pad = n_new
        if (self.next_seq % self.cap) + l_pad > self.cap:
            gap = self.cap - (self.next_seq % self.cap)
            self.next_seq += gap
            _OBS_RING_EVENTS.inc(float(gap), kind="wrap_gap")
        base = self.next_seq
        start_slot = base % self.cap
        ep_id = -1
        if endpoint is not None:
            ep_id = self._ep_table.setdefault(endpoint, len(self._ep_table))
        update = np.zeros((l_pad, 3), dtype=np.int32)
        update[:n_new, 0] = (cols.start[mi] - self.epoch).astype(np.int64)
        update[:n_new, 1] = (cols.end[mi] - self.epoch).astype(np.int64)
        update[:n_new, 2] = ep_id
        self._write(start_slot, update)
        self.evict_seq = max(self.evict_seq, base + l_pad - self.cap)
        new_seqs = base + np.arange(n_new, dtype=np.int64)
        new_slots = new_seqs % self.cap
        self.host_start[new_slots] = cols.start[mi]
        self.host_end[new_slots] = cols.end[mi]
        self.host_ep[new_slots] = ep_id
        ids = cols.ids
        for j, seq in zip(mi.tolist(), new_seqs.tolist()):
            self.slot_of[(scope, ids[j])] = seq
        self.next_seq = base + n_new
        seqs[mi] = new_seqs
        slots = (seqs % self.cap).astype(np.int64)
        self.appended_rows += n_new
        self.appended_bytes += update.nbytes
        _OBS_RING_EVENTS.inc(float(n_new), kind="appended_rows")
        if ledger is not None:
            ledger("h2d_bytes_ring", float(update.nbytes))
        if len(self.slot_of) > 4 * self.cap:
            # drop mappings to evicted sequences
            self.slot_of = {k: s for k, s in self.slot_of.items()
                            if s >= self.evict_seq}
        self._observe()
        return slots.astype(np.int32), int(seqs.min())

    def rebuild(self) -> int:
        """Rewrite the device buffer from the host mirror, every slot
        where it was: the supervisor's rung for a faulted ring (a
        poisoned ring would corrupt every later gather from it). Slot
        preservation is what keeps the index arrays of groups in flight
        valid. The write is in place, ordered like an append. Returns
        the bytes shipped, which the caller bills to ``h2d_bytes_ring``."""
        with self._lock:
            vals = np.zeros((self.cap, 3), dtype=np.int32)
            if self.epoch is not None:
                # int64 on the way, int32 wrap: live slots are in range
                # by the eligibility check; dead ones are never gathered
                vals[:, 0] = (self.host_start - self.epoch).astype(np.int64).astype(np.int32)
                vals[:, 1] = (self.host_end - self.epoch).astype(np.int64).astype(np.int32)
                vals[:, 2] = self.host_ep
            self._write(0, vals)
            self.rebuilds += 1
            _OBS_RING_EVENTS.inc(kind="rebuild")
            return int(vals.nbytes)

    def rel32(self, values: np.ndarray) -> np.ndarray:
        """Absolute µs values rebased to the ring's epoch, int32 (the
        window origins the gathers subtract)."""
        return (values - self.epoch).astype(np.int64).astype(np.int32)

    @property
    def live(self) -> int:
        return min(self.next_seq - self.evict_seq, self.cap)

    def _observe(self) -> None:
        _OBS_RING_FILL.set(self.live / self.cap, ring=self.key)


class DeviceColumnStore:
    """Process-wide registry of the resident column rings, one per
    (tenant, service, partition kind, device, capacity)."""

    def __init__(self) -> None:
        self._rings: Dict[Tuple, ColumnRing] = {}
        self._lock = threading.Lock()

    def ring(self, tenant: Optional[str], svc: str, part: str, device="cpu",
             cap: Optional[int] = None) -> ColumnRing:
        dev = torch.device(device)
        cap = pow2_bucket(int(cap or RING_CAPACITY))
        key = (tenant, svc, part, str(dev), cap)
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                name = "/".join(str(k) for k in (tenant or "-", svc, part))
                ring = self._rings[key] = ColumnRing(name, cap=cap, device=dev)
            return ring

    def rings(self) -> List[ColumnRing]:
        with self._lock:
            return list(self._rings.values())

    def drop_tenant(self, tenant: str) -> int:
        """Drop one tenant's rings (its live migration out): each under
        its own lock, after the gathers and the append recorded on it have
        run on the card, so no queued gather reads a freed buffer and a
        tenant that migrates back starts from fresh rings. Every sequence
        the rings handed out dies with them. Returns the rings dropped."""
        with self._lock:
            keys = [k for k in self._rings if k[0] == tenant]
            rings = [self._rings.pop(k) for k in keys]
        for ring in rings:
            with ring._lock:
                for ev in ring._reads:
                    ev.synchronize()
                if ring._written is not None:
                    ring._written.synchronize()
                ring._reads.clear()
                ring._written = None
                ring._reset(None)
        if rings:
            _OBS_RING_EVENTS.inc(len(rings), kind="tenant_drop")
        return len(rings)

    def clear(self) -> None:
        """Drop every ring (tests, and a fresh start between runs)."""
        with self._lock:
            rings, self._rings = list(self._rings.values()), {}
        if any(r.device.type == "cuda" for r in rings):
            torch.cuda.synchronize()


_STORE = DeviceColumnStore()


def get_store() -> DeviceColumnStore:
    return _STORE
