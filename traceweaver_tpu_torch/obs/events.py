"""Structured JSONL event sink and the ``cli events`` tail (mirrors
``traceweaver_tpu/obs/events.py``).

Every fault-ladder rung and every injected fault lands as one JSON
record per line in an append-only sink, with a timestamp; the fleet's
in-dict ``fault_ladder`` list stays as it was. Record shape (sorted
keys, one object per line)::

    {"event": "retry", "kind": "fault_ladder", "ts": 1754300000.123, ...}

:func:`install` sets one process-wide sink (the CLI's ``--events``);
:func:`emit` returns at once when none is installed.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class EventLog:
    """Append-only JSONL event sink with a recorded byte offset."""

    def __init__(self, path: str) -> None:
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a+b")
        self._f.seek(0, os.SEEK_END)
        self.offset = self._f.tell()
        self.records = 0

    def emit(self, kind: str, event: str, **fields) -> None:
        rec = dict(fields)
        rec["kind"] = kind
        rec["event"] = event
        rec.setdefault("ts", round(time.time(), 6))
        data = (json.dumps(rec, sort_keys=True, default=str) + "\n") \
            .encode("utf-8")
        with self._lock:
            self._f.write(data)
            self._f.flush()
            self.offset += len(data)
            self.records += 1

    def truncate(self, offset: int) -> None:
        with self._lock:
            self._f.truncate(offset)
            self._f.seek(offset)
            self.offset = offset

    def close(self) -> None:
        with self._lock:
            self._f.close()


#: event kinds the port emits (the ``cli events --kind`` values); not
#: enforced on emit, the sink takes any kind
KNOWN_KINDS = (
    "fault_ladder",       # solve-supervisor rungs (retry/bisect/host/quarantine)
    "fault_injected",     # injected faults (runtime/faults.py)
)

_ACTIVE: Optional[EventLog] = None


def install(log: Optional[EventLog]) -> Optional[EventLog]:
    """Install (or clear, with None) the process-wide event sink.
    Returns the previous one so scopes can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = log
    return prev


def active() -> Optional[EventLog]:
    return _ACTIVE


def emit(kind: str, event: str, **fields) -> None:
    """Emit to the installed sink, if any (one global read when not)."""
    log = _ACTIVE
    if log is not None:
        log.emit(kind, event, **fields)


# ---------------------------------------------------------------------------
# `python -m traceweaver_tpu_torch.runtime.cli events`: tail the sink
# ---------------------------------------------------------------------------

def _fmt_record(rec: Dict) -> str:
    """One human line per record: timestamp, kind/event head, then the
    remaining fields as k=v. Dead-letter records (no kind/event) print
    their fields generically — same tool, both formats."""
    ts = rec.pop("ts", None)
    head = []
    if ts is not None:
        try:
            head.append(time.strftime("%H:%M:%S", time.localtime(float(ts)))
                        + ("%.3f" % (float(ts) % 1))[1:])
        except (TypeError, ValueError):
            head.append(str(ts))
    kind = rec.pop("kind", None)
    event = rec.pop("event", None)
    if kind is not None or event is not None:
        head.append("%s/%s" % (kind or "-", event or "-"))
    elif "reason" in rec:
        head.append("deadletter")
    tail = " ".join("%s=%s" % (k, rec[k]) for k in sorted(rec))
    return " ".join(head + ([tail] if tail else []))


def tail_main(argv: List[str]) -> int:
    """``cli events <path> [-n N] [--follow] [--kind K]``: pretty-tail a
    JSONL event (or dead-letter) sink."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.runtime.cli events",
        description="Tail a structured JSONL event sink (fault-ladder "
                    "events and injected faults, one record per line).")
    p.add_argument("path", help="event/dead-letter JSONL file")
    p.add_argument("-n", type=int, default=20,
                   help="show the last N records (default 20; 0 = all)")
    p.add_argument("--follow", action="store_true",
                   help="keep the file open and print records as they "
                        "arrive (Ctrl-C to stop)")
    p.add_argument("--kind", default=None,
                   help="only records whose 'kind' field matches; known "
                        "kinds: " + ", ".join(KNOWN_KINDS))
    args = p.parse_args(argv)
    if not os.path.exists(args.path):
        print(f"events: no such file: {args.path}", file=sys.stderr)
        return 2

    def emit_line(raw) -> None:
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8", errors="replace")
        raw = raw.strip()
        if not raw:
            return
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            print("? " + raw)
            return
        if not isinstance(rec, dict):
            print("? " + raw)
            return
        if args.kind is not None and rec.get("kind") != args.kind:
            return
        print(_fmt_record(dict(rec)))

    # binary mode: the follow loop does byte-offset arithmetic (seek /
    # pread anchors), which text-mode tell() cookies cannot support
    with open(args.path, "rb") as f:
        lines = f.readlines()
        for raw in (lines[-args.n:] if args.n else lines):
            emit_line(raw)
        if not args.follow:
            return 0
        # rotation/truncate splice (EventLog.truncate rewinds to a
        # recorded offset and the writer re-appends). Two detectors, both
        # needed:
        #  - size < offset: plain truncation caught before regrowth;
        #  - the ANCHOR: the last line read, re-verified by pread at its
        #    recorded offset on every idle tick. A truncate+reappend that
        #    regrows past the follower's offset between polls leaves
        #    size >= offset — only the rewritten bytes under the anchor
        #    betray the splice. On mismatch, rewind to the anchor (the
        #    earliest rewritten point the follower can prove) and
        #    re-read: re-emitted records print and the follow never
        #    sticks at a stale offset.
        anchor_pos, anchor_bytes = 0, b""
        if lines and lines[-1].endswith(b"\n"):
            # seed the anchor from the initial dump's last record, so a
            # splice that lands before the first live read is caught too
            anchor_bytes = lines[-1]
            anchor_pos = f.tell() - len(anchor_bytes)
        try:
            while True:
                if anchor_bytes:
                    # verify BEFORE consuming: a splice that already
                    # regrew past our offset would otherwise hand us a
                    # mid-record tail to read (and re-anchor on) first
                    cur = os.pread(f.fileno(), len(anchor_bytes),
                                   anchor_pos)
                    if cur != anchor_bytes:
                        f.seek(anchor_pos)
                        anchor_pos, anchor_bytes = 0, b""
                        continue
                pos = f.tell()
                raw = f.readline()
                if raw.endswith(b"\n"):
                    emit_line(raw)
                    anchor_pos, anchor_bytes = pos, raw
                    continue
                f.seek(pos)  # partial line: re-read once it completes
                try:
                    size = os.path.getsize(args.path)
                except OSError:
                    size = None
                if size is not None and size < pos:
                    f.seek(size)
                    anchor_pos, anchor_bytes = 0, b""
                time.sleep(0.2)
        except KeyboardInterrupt:
            return 0
