"""Write-ahead ingest log: durability between ack and checkpoint
(mirrors ``traceweaver_tpu/stream/wal.py``).

The serve tier acks ``POST /spans`` with 200 the moment the payload is
parsed into open window buffers — but those buffers live in memory until
the next checkpoint. A replica that dies hard (SIGKILL, OOM, power)
between ack and checkpoint silently loses every acked-but-unemitted
span, which defeats the whole premise of reconstructing traces nobody
else can recover. The WAL closes that gap: the raw accepted wire bytes
are appended here *before* the 200 goes out, and resume replays the
tail through the normal ingest path, so the emitted trace set equals an
uncrashed run's byte-for-byte.

Frame format (little-endian)::

    +------+-------+---------+---------+-----------------+
    | TWWL | crc32 | length  |   seq   | payload bytes   |
    | 4 B  | u32   | u32     | u64     | ``length`` B    |
    +------+-------+---------+---------+-----------------+

``crc32`` covers the packed seq + payload, so a corrupt/reused seq is
detected the same as payload rot. ``seq`` is the WAL's own monotonic
append counter — it orders replay and anchors the checkpoint low-water
mark (client-retry dedup uses a *separate* per-tenant client seq carried
inside the payload envelope, not this field).

Segments: appends go to ``wal-<first_seq:016d>.log`` files, rotated once
a segment reaches ``segment_bytes``. ``truncate_below(low)`` deletes
whole segments whose every record is ≤ ``low`` — the checkpoint records
its low-water mark (the last seq applied to checkpointed state), so
segments vanish as soon as their windows are durably checkpointed,
mirroring the sink's offset/truncate splice semantics.

Sync policies (``TW_WAL_SYNC`` in the JAX package, the serve tier's
``ServeConfig.wal_sync`` here):

- ``always`` — write + flush + fsync per append; survives power loss.
- ``batch`` (default) — write + flush to the OS per append (survives
  process death: kill -9, OOM), fsync group-committed on the serve
  pump cadence via :meth:`WriteAheadLog.sync`.
- ``off`` — buffered write only; flushed at close/checkpoint. Documents
  a loss window; exists for the bench baseline.

Torn tails: a partial final frame (torn append, truncated file) is
TRUNCATED to the last CRC-valid frame boundary at open/replay — counted
(``torn_tails``/``torn_bytes``) and evented (``wal_torn_tail``), never
raised. Corruption can only be at the tail because frames are append-
only and truncate drops whole segments.

Fault injection: the ``wal`` site of the plan in force
(:func:`traceweaver_tpu_torch.runtime.faults.active`) gates both the
append (the injected failure writes HALF the frame first — a real torn
append whose client never gets an ack and whose bytes the next replay
truncates) and the fsync path.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.runtime import faults

#: frame header = MAGIC + u32 crc32(seq_bytes + payload) + u32 len + u64 seq
_MAGIC = b"TWWL"
_HEADER = struct.Struct("<4sIIQ")
_SEQ = struct.Struct("<Q")

SYNC_POLICIES = ("always", "batch", "off")

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


def _maybe_fail(site: str) -> None:
    faults.maybe_fail(faults.active(), site)


def _emit(event: str, **fields) -> None:
    _events.emit("serve", event, **fields)


def pack_frame(seq: int, payload: bytes) -> bytes:
    """One CRC-framed WAL record (also the unit torn-tail tests cut)."""
    seq_b = _SEQ.pack(seq)
    crc = zlib.crc32(seq_b + payload)
    return _HEADER.pack(_MAGIC, crc, len(payload), seq) + payload


def scan_frames(raw: bytes) -> Tuple[List[Tuple[int, int, bytes]], int]:
    """Walk ``raw`` frame by frame; returns ``([(offset, seq, payload)],
    valid_end)`` where ``valid_end`` is the byte offset of the first
    invalid frame (== ``len(raw)`` when the tail is clean). Never raises:
    a bad magic, short header, over-long length, or CRC mismatch simply
    ends the valid prefix — the caller truncates there."""
    frames: List[Tuple[int, int, bytes]] = []
    off = 0
    n = len(raw)
    while off + _HEADER.size <= n:
        magic, crc, length, seq = _HEADER.unpack_from(raw, off)
        if magic != _MAGIC:
            break
        end = off + _HEADER.size + length
        if end > n:
            break
        payload = raw[off + _HEADER.size:end]
        if zlib.crc32(_SEQ.pack(seq) + payload) != crc:
            break
        frames.append((off, seq, payload))
        off = end
    return frames, off


def segment_name(first_seq: int) -> str:
    return f"{_SEG_PREFIX}{first_seq:016d}{_SEG_SUFFIX}"


def list_segments(wal_dir: str) -> List[str]:
    """Segment file names in append order (name sorts by first seq)."""
    if not os.path.isdir(wal_dir):
        return []
    return sorted(
        f for f in os.listdir(wal_dir)
        if f.startswith(_SEG_PREFIX) and f.endswith(_SEG_SUFFIX))


def install_bytes(wal_dir: str, raw: bytes) -> int:
    """Install transferred WAL bytes (the failover ``migrate_in`` half):
    concatenated segment bytes from a crashed replica become one fresh
    segment named by the first frame's seq. A torn tail in the transfer
    is truncated here, same contract as open. Returns frames kept."""
    frames, valid_end = scan_frames(raw)
    if not frames:
        return 0
    os.makedirs(wal_dir, exist_ok=True)
    path = os.path.join(wal_dir, segment_name(frames[0][1]))
    with open(path, "wb") as f:
        f.write(raw[:valid_end])
        f.flush()
        os.fsync(f.fileno())
    return len(frames)


def read_all_bytes(wal_dir: str) -> bytes:
    """Concatenated raw segment bytes for transfer (frames are self-
    delimiting, so concatenation in name order is a valid stream)."""
    out = []
    for name in list_segments(wal_dir):
        with open(os.path.join(wal_dir, name), "rb") as f:
            out.append(f.read())
    return b"".join(out)


class WriteAheadLog:
    """Segment-rotated CRC-framed append log under one directory.

    Single-writer: the serve tier appends under the tenant-service lock.
    ``append`` returns the record's WAL seq; durability at return time
    follows the sync policy (see module docstring).
    """

    def __init__(self, wal_dir: str, segment_bytes: int = 16 << 20,
                 sync: str = "batch"):
        if sync not in SYNC_POLICIES:
            raise ValueError(
                f"wal sync policy {sync!r} not in {SYNC_POLICIES}")
        self.dir = wal_dir
        self.segment_bytes = int(segment_bytes)
        self.sync_policy = sync
        self._f = None  # open tail segment handle
        self._f_path: Optional[str] = None
        self._f_size = 0
        self._dirty = False  # bytes flushed to OS but not fsynced
        self._torn = False  # a faulted append left half a frame on disk
        self.last_seq = 0  # highest seq ever appended (or seen at open)
        self.appended = 0
        self.synced = 0
        self.torn_tails = 0
        self.torn_bytes = 0
        os.makedirs(wal_dir, exist_ok=True)
        self._recover_tail()

    # ------------------------------------------------------------- open

    def _recover_tail(self) -> None:
        """Scan the last segment, truncate a torn tail, position the
        append cursor. Older segments are trusted (they were complete
        when rotated); only the tail can be torn."""
        segs = list_segments(self.dir)
        if not segs:
            return
        tail = os.path.join(self.dir, segs[-1])
        with open(tail, "rb") as f:
            raw = f.read()
        frames, valid_end = scan_frames(raw)
        if valid_end < len(raw):
            dropped = len(raw) - valid_end
            self.torn_tails += 1
            self.torn_bytes += dropped
            with open(tail, "r+b") as f:
                f.truncate(valid_end)
            _emit("wal_torn_tail", dir=self.dir, segment=segs[-1],
                  dropped_bytes=dropped, valid_frames=len(frames))
        if frames:
            self.last_seq = frames[-1][1]
        elif valid_end == 0:
            # tail segment held nothing valid; recover last_seq from the
            # previous segment's name-embedded first seq if any remain
            os.unlink(tail)
            segs = list_segments(self.dir)
            if segs:
                prev = os.path.join(self.dir, segs[-1])
                with open(prev, "rb") as f:
                    pframes, _ = scan_frames(f.read())
                if pframes:
                    self.last_seq = pframes[-1][1]
            return
        self._f_path = tail
        self._f = open(tail, "ab")
        self._f_size = valid_end

    # ----------------------------------------------------------- append

    def _rotate(self, first_seq: int) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        self._f_path = os.path.join(self.dir, segment_name(first_seq))
        self._f = open(self._f_path, "ab")
        self._f_size = 0

    def append(self, payload: bytes) -> int:
        """Durably (per policy) append one payload; returns its WAL seq.
        On injected fault, half the frame is written before the raise —
        a genuine torn append the next open truncates."""
        seq = self.last_seq + 1
        frame = pack_frame(seq, payload)
        if self._f is None or self._f_size >= self.segment_bytes:
            self._rotate(seq)
        if self._torn:
            # a previous faulted append left half a frame past the valid
            # boundary; rewind so the log stays scannable if we live on
            # (if we had died, open-time recovery truncates the same way)
            self._f.flush()
            self._f.truncate(self._f_size)
            self._f.seek(self._f_size)
            self._torn = False
        try:
            _maybe_fail("wal")
        except Exception:
            # torn append: half a frame hits the disk, the client never
            # gets an ack, replay truncates the partial record
            self._f.write(frame[:max(1, len(frame) // 2)])
            self._f.flush()
            self._torn = True
            raise
        self._f.write(frame)
        if self.sync_policy != "off":
            self._f.flush()  # to the OS: survives kill -9
        if self.sync_policy == "always":
            self._fsync()
        else:
            self._dirty = True
        self._f_size += len(frame)
        self.last_seq = seq
        self.appended += 1
        return seq

    def _fsync(self) -> None:
        _maybe_fail("wal")
        os.fsync(self._f.fileno())
        self.synced += 1
        self._dirty = False

    def sync(self) -> None:
        """Group commit: flush + fsync pending appends (the ``batch``
        policy's durability point, called on the serve pump cadence)."""
        if self._f is None or not self._dirty:
            return
        self._f.flush()
        self._fsync()

    # ---------------------------------------------------------- cleanup

    def truncate_below(self, low_seq: int) -> int:
        """Drop whole segments whose every record seq is ≤ ``low_seq``
        (their windows are checkpointed — the WAL no longer owns them).
        Returns segments removed. The tail segment is never removed."""
        segs = list_segments(self.dir)
        removed = 0
        for i, name in enumerate(segs):
            if i + 1 < len(segs):
                # a segment's records all precede the next segment's
                # first seq (embedded in its name)
                nxt_first = int(segs[i + 1][len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
                last_in_seg = nxt_first - 1
            else:
                break  # keep the open tail
            if last_in_seg <= low_seq:
                path = os.path.join(self.dir, name)
                if path != self._f_path:
                    os.unlink(path)
                    removed += 1
            else:
                break
        return removed

    # ----------------------------------------------------------- replay

    def replay(self, start_seq: int = 0) -> Iterator[Tuple[int, bytes]]:
        """Yield ``(seq, payload)`` for every record with seq >
        ``start_seq``, in append order, across segments. Torn tails were
        already truncated at open; a mid-stream scan stop (impossible in
        an untampered log) simply ends that segment's yield."""
        for name in list_segments(self.dir):
            with open(os.path.join(self.dir, name), "rb") as f:
                raw = f.read()
            frames, _ = scan_frames(raw)
            for _off, seq, payload in frames:
                if seq > start_seq:
                    yield seq, payload

    # ------------------------------------------------------------ misc

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
            self._f = None

    def destroy(self) -> None:
        """Close and delete every segment (migrate_out: the checkpoint
        transferred at migrate time fully covers the log)."""
        self.close()
        for name in list_segments(self.dir):
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    def stats(self) -> dict:
        return dict(
            last_seq=self.last_seq,
            appended=self.appended,
            synced=self.synced,
            torn_tails=self.torn_tails,
            torn_bytes=self.torn_bytes,
            segments=len(list_segments(self.dir)),
            sync_policy=self.sync_policy,
        )
