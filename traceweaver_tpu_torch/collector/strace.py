"""strace log reassembly into per-connection byte streams.

Port of the reference span-collector's offline strace parser
(reference: src/span_collector/http2_parser/parser.py:299-486): an
``strace -f`` log interleaves ``read``/``write``/``close`` syscalls from
many threads, including split ``<unfinished ...>`` / ``<... resumed>``
pairs. This module reassembles them into bidirectional per-(fd, iteration)
byte streams — an fd generation ends at ``close`` — while recording which
thread (pid) contributed every byte range, so HTTP/2 events recovered from
the streams can be attributed to threads
(:mod:`traceweaver_tpu_torch.collector.threading_model`).

The nine line shapes handled mirror the reference's pattern1..pattern9
(parser.py:299-307), via a single tokenizer instead of nine regexes.

Mirrors ``traceweaver_tpu/collector/strace.py``; the port keeps its own copy.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# One regex per syscall family, complete and split forms
# (reference parser.py:299-307 pattern1..pattern9). The optional ``ts``
# group accepts ``strace -ttt`` epoch timestamps (seconds.micro) right
# after the pid — the capture ingress (collector/source.py) needs real
# event times; logs recorded without ``-ttt`` still parse (ts=None, and
# the parser substitutes a deterministic line-sequence clock).
_PRE = r'^(?P<pid>\d+)\s+(?:(?P<ts>\d+\.\d+)\s+)?'
_RE_COMPLETE = re.compile(
    _PRE + r'(?P<op>read|write)\((?P<fd>\d+),\s*"(?P<data>(?:[^"\\]|\\.)*)"'
    r'(?:\.\.\.)?,\s*(?P<count>\d+)\)\s*=\s*(?P<ret>-?\d+)'
)
_RE_READ_UNFINISHED = re.compile(
    _PRE + r'read\((?P<fd>\d+),\s*<unfinished\s+\.+>'
)
_RE_READ_RESUMED = re.compile(
    _PRE + r'<\.+\s+read resumed>\s*"(?P<data>(?:[^"\\]|\\.)*)"'
    r'(?:\.\.\.)?,\s*(?P<count>\d+)\)\s*=\s*(?P<ret>-?\d+)'
)
_RE_WRITE_UNFINISHED = re.compile(
    _PRE + r'write\((?P<fd>\d+),\s*"(?P<data>(?:[^"\\]|\\.)*)"'
    r'(?:\.\.\.)?,\s*(?P<count>\d+)\s*<unfinished\s+\.+>'
)
_RE_WRITE_RESUMED = re.compile(
    _PRE + r'<\.+\s+write resumed>\s*\)\s*=\s*(?P<ret>-?\d+)'
)
_RE_CLOSE = re.compile(
    _PRE + r'close\((?P<fd>\d+)\)\s*=\s*(?P<ret>-?\d+)'
)
_RE_CLOSE_UNFINISHED = re.compile(
    _PRE + r'close\((?P<fd>\d+)\s*<unfinished\s+\.*>'
)
_RE_CLOSE_RESUMED = re.compile(
    _PRE + r'<\.*\s*close resumed>\s*\)\s*=\s*(?P<ret>-?\d+)'
)

_OCTAL = frozenset("01234567")


def unescape_strace(s: str) -> bytes:
    """Decode strace's C-style string escaping (octal by default, hex under
    ``strace -x``) into raw bytes."""
    out = bytearray()
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c != "\\":
            out.append(ord(c) & 0xFF)
            i += 1
            continue
        i += 1
        if i >= n:
            break
        e = s[i]
        if e == "x":
            j = i + 1
            hexdigits = ""
            while j < n and len(hexdigits) < 2 and s[j] in "0123456789abcdefABCDEF":
                hexdigits += s[j]
                j += 1
            out.append(int(hexdigits, 16) if hexdigits else ord("x"))
            i = j
        elif e in _OCTAL:
            j = i
            digits = ""
            while j < n and len(digits) < 3 and s[j] in _OCTAL:
                digits += s[j]
                j += 1
            out.append(int(digits, 8) & 0xFF)
            i = j
        else:
            out.append({
                "n": 10, "t": 9, "r": 13, "f": 12, "v": 11, "b": 8,
                "a": 7, "\\": 92, '"': 34, "'": 39, "0": 0,
            }.get(e, ord(e)))
            i += 1
    return bytes(out)


@dataclass
class ByteRange:
    """Attribution of one syscall's bytes within a direction stream."""

    pid: int
    start: int
    end: int
    seq: int  # global line order of the completing syscall
    # capture timestamp of the syscall (µs since epoch under strace
    # -ttt; the synthetic line-sequence clock otherwise) — the raw,
    # per-source clock the skew estimator corrects, never solver time
    ts_us: float = 0.0


@dataclass
class FdStream:
    """One fd generation (between opens/closes) with both directions."""

    fd: int
    iteration: int
    inbound: bytes = b""      # bytes the process read
    outbound: bytes = b""     # bytes the process wrote
    read_ranges: List[ByteRange] = field(default_factory=list)
    write_ranges: List[ByteRange] = field(default_factory=list)

    def pid_at(self, direction: str, offset: int) -> Optional[int]:
        """The thread that read/wrote the byte at ``offset``."""
        ranges = self.read_ranges if direction == "in" else self.write_ranges
        for r in ranges:
            if r.start <= offset < r.end:
                return r.pid
        return None

    def ts_at(self, direction: str, offset: int) -> Optional[float]:
        """Capture timestamp (µs, raw source clock) of the syscall that
        carried the byte at ``offset``; None when unattributed."""
        ranges = self.read_ranges if direction == "in" else self.write_ranges
        for r in ranges:
            if r.start <= offset < r.end:
                return r.ts_us
        return None


@dataclass
class _Pending:
    op: str
    fd: Optional[int]
    data: Optional[str] = None
    count: Optional[int] = None
    ts_us: Optional[float] = None


class StraceParser:
    """Streaming parser over strace log lines.

    Two optional hooks let a live consumer ride the parse incrementally
    (the capture ingress, :mod:`traceweaver_tpu_torch.collector.source`):

    - ``payload_hook(key, direction, payload, ts_us) -> bool`` fires per
      completed read/write payload *before* it lands in the stream
      buffers; returning False discards the payload (the capture-loss
      fault site drops chunks here, so the buffers always match what the
      consumer actually saw);
    - ``close_hook(key)`` fires when an fd generation ends, so half-open
      exchanges can be closed out promptly instead of at end-of-log.
    """

    def __init__(self) -> None:
        self.streams: Dict[Tuple[int, int], FdStream] = {}
        self._iteration: Dict[int, int] = {}
        self._in_buf: Dict[Tuple[int, int], bytearray] = {}
        self._out_buf: Dict[Tuple[int, int], bytearray] = {}
        self._pending: Dict[int, _Pending] = {}  # per-pid outstanding call
        self._seq = 0
        self.unmatched_lines = 0
        self.payload_hook = None  # (key, dir, payload, ts_us) -> keep?
        self.close_hook = None    # (key) -> None
        self.saw_timestamps = False

    # -- helpers ----------------------------------------------------------

    def _key(self, fd: int) -> Tuple[int, int]:
        return (fd, self._iteration.get(fd, 0))

    def _stream(self, fd: int) -> Tuple[FdStream, bytearray, bytearray]:
        key = self._key(fd)
        if key not in self.streams:
            self.streams[key] = FdStream(fd=fd, iteration=key[1])
            self._in_buf[key] = bytearray()
            self._out_buf[key] = bytearray()
        return self.streams[key], self._in_buf[key], self._out_buf[key]

    def _record(self, pid: int, op: str, fd: int, data_str: str,
                ret: int, ts_us: Optional[float] = None) -> None:
        if ret <= 0:
            return
        stream, in_buf, out_buf = self._stream(fd)
        payload = unescape_strace(data_str)[:ret]
        if ts_us is None:
            # no -ttt stamps in this log: a deterministic line-sequence
            # clock (1 ms per line) keeps relative order meaningful
            ts_us = self._seq * 1000.0
        direction = "in" if op == "read" else "out"
        if self.payload_hook is not None and not self.payload_hook(
                self._key(fd), direction, payload, ts_us):
            return
        if op == "read":
            stream.read_ranges.append(
                ByteRange(pid, len(in_buf), len(in_buf) + len(payload),
                          self._seq, ts_us)
            )
            in_buf.extend(payload)
        else:
            stream.write_ranges.append(
                ByteRange(pid, len(out_buf), len(out_buf) + len(payload),
                          self._seq, ts_us)
            )
            out_buf.extend(payload)

    def _close(self, fd: int) -> None:
        key = self._key(fd)
        if key in self.streams:
            self._iteration[fd] = key[1] + 1
            if self.close_hook is not None:
                self.close_hook(key)

    # -- line handling ----------------------------------------------------

    def _ts(self, m) -> Optional[float]:
        raw = m.groupdict().get("ts")
        if not raw:
            return None
        self.saw_timestamps = True
        return float(raw) * 1e6

    def feed_line(self, line: str) -> None:
        self._seq += 1
        line = line.strip()
        if not line:
            return

        m = _RE_COMPLETE.match(line)
        if m:
            self._record(int(m["pid"]), m["op"], int(m["fd"]), m["data"],
                         int(m["ret"]), ts_us=self._ts(m))
            return
        m = _RE_READ_UNFINISHED.match(line)
        if m:
            self._pending[int(m["pid"])] = _Pending("read", int(m["fd"]))
            return
        m = _RE_READ_RESUMED.match(line)
        if m:
            pending = self._pending.pop(int(m["pid"]), None)
            if pending is not None and pending.op == "read":
                # reads stamp at the RESUMED line: that is when the data
                # actually arrived in the process
                self._record(int(m["pid"]), "read", pending.fd, m["data"],
                             int(m["ret"]), ts_us=self._ts(m))
            return
        m = _RE_WRITE_UNFINISHED.match(line)
        if m:
            # writes stamp at the UNFINISHED line: the payload was
            # submitted (and visible on the wire) before the call blocked
            self._pending[int(m["pid"])] = _Pending(
                "write", int(m["fd"]), m["data"], int(m["count"]),
                ts_us=self._ts(m)
            )
            return
        m = _RE_WRITE_RESUMED.match(line)
        if m:
            pending = self._pending.pop(int(m["pid"]), None)
            if pending is not None and pending.op == "write":
                self._record(int(m["pid"]), "write", pending.fd,
                             pending.data, int(m["ret"]),
                             ts_us=pending.ts_us)
            return
        m = _RE_CLOSE.match(line)
        if m:
            self._close(int(m["fd"]))
            return
        m = _RE_CLOSE_UNFINISHED.match(line)
        if m:
            self._pending[int(m["pid"])] = _Pending("close", int(m["fd"]))
            return
        m = _RE_CLOSE_RESUMED.match(line)
        if m:
            pending = self._pending.pop(int(m["pid"]), None)
            if pending is not None and pending.op == "close":
                self._close(pending.fd)
            return
        self.unmatched_lines += 1

    def finish(self) -> Dict[Tuple[int, int], FdStream]:
        """Freeze buffers into the stream objects and return them."""
        for key, stream in self.streams.items():
            stream.inbound = bytes(self._in_buf[key])
            stream.outbound = bytes(self._out_buf[key])
        return self.streams


def parse_strace_log(text: str) -> Dict[Tuple[int, int], FdStream]:
    """Parse a whole ``strace -f`` log into per-(fd, iteration) streams."""
    parser = StraceParser()
    for line in text.splitlines():
        parser.feed_line(line)
    return parser.finish()
