"""HTTP/2 (RFC 7540) frame parsing and capture replay.

The reference's span-collector prototype replays captured per-fd byte
streams through paired ``h2`` client+server connection state machines to
recover ``RequestReceived``/``ResponseReceived`` events
(reference: src/span_collector/http2_parser/parser.py:69-159, ``handle3``).
This module is the self-contained equivalent: a frame splitter tolerant of
partial/truncated captures, HEADERS+CONTINUATION reassembly through the
:mod:`~traceweaver_tpu_torch.collector.hpack` codec, and per-direction replay
that emits request/response/data/trailers events with byte offsets (so
captured syscalls can be attributed to the threads that issued them).

Mirrors ``traceweaver_tpu/collector/http2.py``; the port keeps its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from traceweaver_tpu_torch.collector.hpack import Decoder, Header, HpackError

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# Frame types (RFC 7540 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# Flags
FLAG_END_STREAM = 0x1   # DATA / HEADERS
FLAG_ACK = 0x1          # SETTINGS / PING
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20


class Http2ParseError(ValueError):
    pass


@dataclass
class Frame:
    type: int
    flags: int
    stream_id: int
    payload: bytes
    offset: int  # byte offset of the frame header within the direction


def split_frames(data: bytes, start: int = 0) -> Iterator[Frame]:
    """Yield frames from a contiguous byte stream; stops cleanly at a
    trailing partial frame (captures often end mid-frame)."""
    pos = start
    n = len(data)
    while pos + 9 <= n:
        length = int.from_bytes(data[pos:pos + 3], "big")
        ftype = data[pos + 3]
        flags = data[pos + 4]
        stream_id = int.from_bytes(data[pos + 5:pos + 9], "big") & 0x7FFFFFFF
        if pos + 9 + length > n:
            return  # truncated final frame
        yield Frame(ftype, flags, stream_id, data[pos + 9:pos + 9 + length],
                    pos)
        pos += 9 + length


def _strip_padding(frame: Frame) -> bytes:
    payload = frame.payload
    if frame.flags & FLAG_PADDED:
        if not payload:
            raise Http2ParseError("PADDED frame with empty payload")
        pad = payload[0]
        payload = payload[1:]
        if pad > len(payload):
            raise Http2ParseError("padding exceeds payload")
        payload = payload[:len(payload) - pad]
    return payload


def headers_fragment(frame: Frame) -> bytes:
    """The HPACK fragment of a HEADERS frame (padding/priority stripped)."""
    payload = _strip_padding(frame)
    if frame.type == HEADERS and frame.flags & FLAG_PRIORITY:
        if len(payload) < 5:
            raise Http2ParseError("HEADERS priority block truncated")
        payload = payload[5:]
    return payload


# ---------------------------------------------------------------------------
# Event replay
# ---------------------------------------------------------------------------

@dataclass
class Event:
    kind: str          # request | response | trailers | data | stream_end
    stream_id: int
    offset: int        # where the originating frame started in the stream
    headers: List[Header] = field(default_factory=list)
    data_len: int = 0
    end_stream: bool = False


class DirectionReplayer:
    """Replays one direction of an HTTP/2 connection (all bytes one peer
    sent). Maintains the direction's HPACK dynamic table; classifies header
    blocks as request (``:method``), response (``:status``) or trailers.
    """

    def __init__(self) -> None:
        self.decoder = Decoder()
        self._buffer = bytearray()
        self._consumed = 0
        self._preface_checked = False
        # streams that already saw their initial header block
        self._opened: Dict[int, bool] = {}
        # pending HEADERS awaiting CONTINUATION: (stream, flags, frag, offset)
        self._pending: Optional[Tuple[int, int, bytearray, int]] = None
        # capture-loss ledger (consumed by the collector ingress): header
        # blocks dropped because a CONTINUATION sequence was interrupted
        # or re-keyed, and HPACK fragments the lost-bootstrap tolerance
        # skipped — every tolerated corruption is COUNTED, never silent
        self.dropped_header_blocks = 0
        self.decode_errors = 0

    def feed(self, data: bytes) -> List[Event]:
        """Add captured bytes; returns newly completed events."""
        self._buffer.extend(data)
        return list(self._drain())

    def _drain(self) -> Iterator[Event]:
        buf = bytes(self._buffer)
        pos = 0
        if not self._preface_checked:
            if buf.startswith(PREFACE):
                pos = len(PREFACE)
                self._preface_checked = True
            elif PREFACE.startswith(buf):
                return  # still a strict preface prefix: need more bytes
            else:
                # diverged from the preface: this direction starts at a
                # frame boundary (a server direction, or a mid-stream
                # attach) — decide NOW so short captures (a lone 10-byte
                # response frame) don't wait forever for 24 bytes
                self._preface_checked = True
        for frame in split_frames(buf, pos):
            pos = frame.offset + 9 + len(frame.payload)
            yield from self._handle(frame)
        # keep the unconsumed tail
        del self._buffer[:pos]
        self._consumed += pos

    @property
    def pending_bytes(self) -> int:
        """Unconsumed tail bytes (a capture that ended mid-frame)."""
        return len(self._buffer)

    @property
    def pending_headers(self) -> bool:
        """A HEADERS block still awaiting CONTINUATION frames."""
        return self._pending is not None

    def _handle(self, frame: Frame) -> Iterator[Event]:
        abs_offset = self._consumed + frame.offset
        if self._pending is not None and frame.type != CONTINUATION:
            # header block interrupted: drop it (tolerant replay)
            self._pending = None
            self.dropped_header_blocks += 1
        if frame.type == HEADERS:
            frag = headers_fragment(frame)
            if frame.flags & FLAG_END_HEADERS:
                yield from self._header_block(
                    frame.stream_id, frame.flags, bytes(frag), abs_offset
                )
            else:
                self._pending = (frame.stream_id, frame.flags,
                                 bytearray(frag), abs_offset)
        elif frame.type == CONTINUATION and self._pending is not None:
            stream_id, flags, frag, offset = self._pending
            if frame.stream_id == stream_id:
                frag.extend(frame.payload)
                if frame.flags & FLAG_END_HEADERS:
                    self._pending = None
                    yield from self._header_block(
                        stream_id, flags, bytes(frag), offset
                    )
            else:
                # interleaved CONTINUATION for a different stream: a
                # protocol error on a live connection, but a real capture
                # artifact under loss/churn — drop the pending block,
                # counted (RFC 7540 §6.10 requires contiguity)
                self._pending = None
                self.dropped_header_blocks += 1
        elif frame.type == DATA:
            payload = _strip_padding(frame)
            yield Event("data", frame.stream_id, abs_offset,
                        data_len=len(payload),
                        end_stream=bool(frame.flags & FLAG_END_STREAM))
            if frame.flags & FLAG_END_STREAM:
                yield Event("stream_end", frame.stream_id, abs_offset)
        elif frame.type == RST_STREAM:
            self._opened.pop(frame.stream_id, None)

    def _header_block(self, stream_id: int, flags: int, fragment: bytes,
                      offset: int) -> Iterator[Event]:
        try:
            headers = self.decoder.decode(fragment)
        except HpackError:
            # Mid-connection attach: the dynamic table bootstrap is lost.
            # Tolerate and skip, like the reference's error_count path
            # (parser.py:250-258).
            self.decode_errors += 1
            return
        names = {n for n, _ in headers}
        end_stream = bool(flags & FLAG_END_STREAM)
        if self._opened.get(stream_id):
            kind = "trailers"
        elif ":method" in names:
            kind = "request"
        elif ":status" in names:
            kind = "response"
        else:
            kind = "trailers"
        self._opened[stream_id] = True
        yield Event(kind, stream_id, offset, headers=headers,
                    end_stream=end_stream)
        if end_stream:
            yield Event("stream_end", stream_id, offset)


def looks_like_http2(inbound: bytes, outbound: bytes) -> bool:
    """Heuristic: a connection is HTTP/2 if either direction starts with the
    preface or with a well-formed SETTINGS frame (mid-stream attach)."""
    for direction in (inbound, outbound):
        if direction.startswith(PREFACE):
            return True
        if len(direction) >= 9:
            length = int.from_bytes(direction[:3], "big")
            if direction[3] == SETTINGS and direction[4] in (0, FLAG_ACK) \
                    and length % 6 == 0 and length <= 1024:
                return True
    return False


def replay_connection(
    inbound: bytes, outbound: bytes
) -> Tuple[List[Event], List[Event]]:
    """Replay both directions of one connection independently (each carries
    its own HPACK context). Returns (inbound_events, outbound_events)."""
    return (DirectionReplayer().feed(inbound),
            DirectionReplayer().feed(outbound))
