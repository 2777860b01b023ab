"""HPACK (RFC 7541) header compression codec.

Self-contained replacement for the ``h2``/``hpack`` dependency the
reference's span-collector prototype leans on for HTTP/2 header decoding
(reference: src/span_collector/http2_parser/parser.py:69-159, which replays
captured byte streams through paired h2 connection state machines). The
image ships neither package, so the collector port implements the codec:

- integer primitive with N-bit prefix (RFC 7541 §5.1);
- string literals, raw or Huffman-coded (§5.2, Appendix B canonical code);
- indexed / literal-with-incremental-indexing / literal-without-indexing /
  never-indexed field representations (§6.2);
- dynamic table with size updates and eviction (§4);
- an encoder (used by tests and synthetic capture generation) emitting
  either raw or Huffman string literals.

Constants live in :mod:`traceweaver_tpu_torch.collector._rfc7541` (spec data).

Mirrors ``traceweaver_tpu/collector/hpack.py``; the port keeps its own copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.collector._rfc7541 import (
    HUFFMAN_CODES,
    HUFFMAN_LENGTHS,
    STATIC_TABLE,
)

Header = Tuple[str, str]


class HpackError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Integer primitive (RFC 7541 §5.1)
# ---------------------------------------------------------------------------

def encode_integer(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    """Encode ``value`` with an N-bit prefix; ``flags`` sets bits above the
    prefix in the first octet."""
    if value < 0:
        raise HpackError("negative integer")
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = [flags | limit]
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    """Decode an N-bit-prefix integer at ``pos``; returns (value, new_pos)."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer continuation")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 63:
            raise HpackError("integer overflow")
        if not b & 0x80:
            return value, pos


# ---------------------------------------------------------------------------
# Huffman code (RFC 7541 Appendix B)
# ---------------------------------------------------------------------------

def _build_decode_tree():
    # Binary trie as nested 2-lists; leaves are symbol ints.
    root: list = [None, None]
    for sym in range(257):
        code = HUFFMAN_CODES[sym]
        length = HUFFMAN_LENGTHS[sym]
        node = root
        for bit_pos in range(length - 1, -1, -1):
            bit = (code >> bit_pos) & 1
            if bit_pos == 0:
                node[bit] = sym
            else:
                if node[bit] is None:
                    node[bit] = [None, None]
                node = node[bit]
    return root


_DECODE_TREE = _build_decode_tree()
_EOS = 256


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _DECODE_TREE
    partial_bits = 0    # bits consumed since the last completed symbol
    partial_all_ones = True
    for byte in data:
        for bit_pos in range(7, -1, -1):
            bit = (byte >> bit_pos) & 1
            node = node[bit]
            if node is None:
                raise HpackError("invalid Huffman code")
            partial_bits += 1
            partial_all_ones = partial_all_ones and bit == 1
            if isinstance(node, int):
                if node == _EOS:
                    raise HpackError("EOS in Huffman string")
                out.append(node)
                node = _DECODE_TREE
                partial_bits = 0
                partial_all_ones = True
    # Trailing bits must be a strict EOS prefix: all ones, fewer than 8
    # (RFC 7541 §5.2).
    if partial_bits and (partial_bits > 7 or not partial_all_ones):
        raise HpackError("invalid Huffman padding")
    return bytes(out)


def huffman_encode(data: bytes) -> bytes:
    bits = 0
    nbits = 0
    out = bytearray()
    for byte in data:
        code = HUFFMAN_CODES[byte]
        length = HUFFMAN_LENGTHS[byte]
        bits = (bits << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((bits >> nbits) & 0xFF)
    if nbits:
        # pad with EOS prefix (all ones)
        out.append(((bits << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# String literals (RFC 7541 §5.2)
# ---------------------------------------------------------------------------

def encode_string(s: bytes, huffman: bool = False) -> bytes:
    if huffman:
        coded = huffman_encode(s)
        return encode_integer(len(coded), 7, flags=0x80) + coded
    return encode_integer(len(s), 7) + s


def decode_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huffman = bool(data[pos] & 0x80)
    length, pos = decode_integer(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("truncated string payload")
    raw = data[pos:pos + length]
    pos += length
    return (huffman_decode(raw) if huffman else raw), pos


# ---------------------------------------------------------------------------
# Dynamic table (RFC 7541 §4) + decoder / encoder
# ---------------------------------------------------------------------------

def _entry_size(name: bytes, value: bytes) -> int:
    return len(name) + len(value) + 32  # §4.1 overhead constant


_STATIC = [(n.encode(), v.encode()) for n, v in STATIC_TABLE]
_STATIC_LOOKUP: Dict[bytes, int] = {}
_STATIC_FULL_LOOKUP: Dict[Tuple[bytes, bytes], int] = {}
for _i, (_n, _v) in enumerate(_STATIC):
    _STATIC_LOOKUP.setdefault(_n, _i + 1)
    _STATIC_FULL_LOOKUP.setdefault((_n, _v), _i + 1)


class _DynamicTable:
    def __init__(self, max_size: int = 4096):
        self.entries: List[Tuple[bytes, bytes]] = []  # newest first
        self.size = 0
        self.max_size = max_size
        self.protocol_max = max_size

    def add(self, name: bytes, value: bytes) -> None:
        self.entries.insert(0, (name, value))
        self.size += _entry_size(name, value)
        self._evict()

    def resize(self, new_max: int) -> None:
        self.max_size = new_max
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.entries:
            n, v = self.entries.pop()
            self.size -= _entry_size(n, v)

    def get(self, index: int) -> Tuple[bytes, bytes]:
        # 1-based global index space: static table first (§2.3.3)
        if 1 <= index <= len(_STATIC):
            return _STATIC[index - 1]
        d = index - len(_STATIC) - 1
        if 0 <= d < len(self.entries):
            return self.entries[d]
        raise HpackError(f"index {index} out of table bounds")


class Decoder:
    """Stateful HPACK decoder (one per connection direction)."""

    def __init__(self, max_table_size: int = 4096):
        self.table = _DynamicTable(max_table_size)

    def decode(self, data: bytes) -> List[Header]:
        headers: List[Header] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field (§6.1)
                index, pos = decode_integer(data, pos, 7)
                if index == 0:
                    raise HpackError("index 0 in indexed representation")
                name, value = self.table.get(index)
            elif b & 0x40:  # literal with incremental indexing (§6.2.1)
                index, pos = decode_integer(data, pos, 6)
                name, value, pos = self._literal(data, pos, index)
                self.table.add(name, value)
            elif b & 0x20:  # dynamic table size update (§6.3)
                new_size, pos = decode_integer(data, pos, 5)
                if new_size > self.table.protocol_max:
                    raise HpackError("table size update above protocol max")
                self.table.resize(new_size)
                continue
            else:  # literal without indexing / never indexed (§6.2.2/6.2.3)
                index, pos = decode_integer(data, pos, 4)
                name, value, pos = self._literal(data, pos, index)
            headers.append((name.decode("utf-8", "replace"),
                            value.decode("utf-8", "replace")))
        return headers

    def _literal(self, data: bytes, pos: int,
                 index: int) -> Tuple[bytes, bytes, int]:
        if index:
            name = self.table.get(index)[0]
        else:
            name, pos = decode_string(data, pos)
        value, pos = decode_string(data, pos)
        return name, value, pos


class Encoder:
    """Stateful HPACK encoder; used by tests and synthetic captures."""

    def __init__(self, max_table_size: int = 4096, huffman: bool = False):
        self.table = _DynamicTable(max_table_size)
        self.huffman = huffman

    def _dyn_index(self, name: bytes,
                   value: Optional[bytes]) -> Optional[int]:
        for i, (n, v) in enumerate(self.table.entries):
            if n == name and (value is None or v == value):
                return len(_STATIC) + 1 + i
        return None

    def encode(self, headers: List[Header]) -> bytes:
        out = bytearray()
        for name_s, value_s in headers:
            name = name_s.encode()
            value = value_s.encode()
            full = _STATIC_FULL_LOOKUP.get((name, value))
            if full is None:
                full = self._dyn_index(name, value)
            if full is not None:
                out += encode_integer(full, 7, flags=0x80)
                continue
            name_idx = _STATIC_LOOKUP.get(name) or self._dyn_index(name, None)
            if name_idx:
                out += encode_integer(name_idx, 6, flags=0x40)
            else:
                out += encode_integer(0, 6, flags=0x40)
                out += encode_string(name, self.huffman)
            out += encode_string(value, self.huffman)
            self.table.add(name, value)
        return bytes(out)
