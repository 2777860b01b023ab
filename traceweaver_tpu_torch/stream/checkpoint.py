"""Checkpointed resume for the streaming reconstructor (mirrors
``traceweaver_tpu/stream/checkpoint.py``).

A checkpoint is one atomically written pickle of the service's mutable
state: the replay offset (``consumed`` events), the open window buffers,
the live span store, the watermark, the scheduler's queued and spilled
windows, the carried per-service statistics, the plan cache, the grader,
the counters, and the sink's byte offset.

Resume contract:

- the source is not pickled: a replay source is deterministic, so the
  resumed service re-opens it and skips the first ``consumed`` events;
- the sink is truncated back to the checkpointed byte offset before the
  resumed run appends: windows emitted after the last checkpoint are
  re-solved from identical state and re-emitted byte for byte, so the
  final sink equals the uninterrupted run's (no loss, no double emit).

Integrity contract (version 2):

- every checkpoint carries a CRC32 trailer (``MAGIC + crc32 + length``
  over the pickle payload), so truncation and bit rot are detected at
  load;
- :func:`save_checkpoint` rotates the previous checkpoint to
  ``<path>.prev`` before replacing it, so a last good file always stays;
- :func:`load_checkpoint` falls back to ``<path>.prev`` when the primary
  is corrupt or truncated (warned on stderr, marked
  ``_recovered_from_prev`` in the returned state); only both
  generations unreadable is fatal (:class:`CheckpointCorrupt`);
- version-1 checkpoints (no trailer) are still read;
- :func:`read_checkpoint_bytes` and :func:`write_checkpoint_bytes` carry
  a checkpoint between processes for live migration, verified at both
  ends.

The state is host material only: spans, numpy statistics inside the
``EdgeDist``s, dicts; no tensor on the card. The pickles name the
port's own classes (``traceweaver_tpu_torch.*``), so the JAX package
cannot read the port's checkpoints, nor the port the JAX package's.
Both save and load draw from the ``checkpoint`` fault site
(:mod:`traceweaver_tpu_torch.runtime.faults`).
"""

from __future__ import annotations

import os
import pickle
import struct
import sys
import zlib
from typing import Dict

from traceweaver_tpu_torch.runtime import faults

CHECKPOINT_VERSION = 2

#: trailer = MAGIC + u32 crc32(payload) + u64 len(payload), little-endian
_MAGIC = b"TWCK"
_TRAILER = struct.Struct("<4sIQ")


class CheckpointCorrupt(ValueError):
    """The checkpoint file failed its integrity check (bad CRC, short
    payload, or unreadable pickle) and no fallback generation worked."""


def save_checkpoint(path: str, state: Dict) -> None:
    """Atomic write with integrity trailer and keep-last-good rotation:
    pickle to a sibling temp file, append the CRC trailer, fsync, rotate
    the current checkpoint to ``path.prev``, rename into place."""
    faults.maybe_fail(faults.active(), "checkpoint")
    payload_dict = dict(state)
    payload_dict["version"] = CHECKPOINT_VERSION
    payload = pickle.dumps(payload_dict, protocol=pickle.HIGHEST_PROTOCOL)
    trailer = _TRAILER.pack(_MAGIC, zlib.crc32(payload), len(payload))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(payload)
        f.write(trailer)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        # keep-last-good: the generation being replaced becomes .prev so
        # a corrupt/truncated primary never strands the service
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


def verify_checkpoint_bytes(raw: bytes, label: str = "<bytes>") -> bytes:
    """Trailer integrity check over in-memory checkpoint bytes; returns
    the pickle payload (trailer stripped). Version-1 bytes (no trailer)
    pass through unverified."""
    if len(raw) >= _TRAILER.size and raw[-_TRAILER.size:][:4] == _MAGIC:
        magic, crc, length = _TRAILER.unpack(raw[-_TRAILER.size:])
        payload = raw[:-_TRAILER.size]
        if length != len(payload):
            raise CheckpointCorrupt(
                f"checkpoint {label}: trailer says {length} payload bytes, "
                f"got {len(payload)} (truncated or overwritten)")
        if zlib.crc32(payload) != crc:
            raise CheckpointCorrupt(
                f"checkpoint {label}: CRC mismatch (bit rot or torn write)")
        return payload
    # no trailer: either a version-1 checkpoint (legal, pre-integrity
    # format) or a truncation that ate the trailer — a pickle load
    # distinguishes (a truncated pickle cannot load)
    return raw


def read_checkpoint_bytes(path: str) -> bytes:
    """Read a checkpoint file verbatim for transfer, verifying its CRC
    trailer first (the ``migrate_out`` half of live migration): a torn
    read is refused at the source."""
    with open(path, "rb") as f:
        raw = f.read()
    verify_checkpoint_bytes(raw, label=path)
    return raw


def write_checkpoint_bytes(path: str, raw: bytes) -> None:
    """Install transferred checkpoint bytes (the ``migrate_in`` half):
    verify the trailer, so a torn transfer is refused at the
    destination, then write with :func:`save_checkpoint`'s fsync,
    keep-last-good rotation and atomic rename."""
    verify_checkpoint_bytes(raw, label=path)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


def _load_one(path: str) -> Dict:
    """Read + verify one checkpoint file (v2 trailer or bare v1 pickle).
    Raises :class:`CheckpointCorrupt` on any integrity failure."""
    with open(path, "rb") as f:
        raw = f.read()
    payload = verify_checkpoint_bytes(raw, label=path)
    try:
        state = pickle.loads(payload)
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path}: unreadable pickle "
            f"({type(e).__name__}: {e})") from e
    version = state.get("version")
    if version not in (1, CHECKPOINT_VERSION):
        raise ValueError(
            f"checkpoint {path} has version {version}, "
            f"this build reads versions 1..{CHECKPOINT_VERSION}")
    return state


def load_checkpoint(path: str) -> Dict:
    """Load a checkpoint, falling back to the rotated ``path.prev`` when
    the primary fails its integrity check. A recovered load is warned on
    stderr and marked in the returned state (``_recovered_from_prev``)
    so the service can count it; only primary+fallback both failing is
    fatal."""
    faults.maybe_fail(faults.active(), "checkpoint")
    try:
        return _load_one(path)
    except CheckpointCorrupt as primary_err:
        prev = path + ".prev"
        if not os.path.exists(prev):
            raise
        try:
            state = _load_one(prev)
        except (CheckpointCorrupt, ValueError) as prev_err:
            raise CheckpointCorrupt(
                f"checkpoint {path} is corrupt ({primary_err}) and the "
                f"last-good fallback failed too ({prev_err})"
            ) from primary_err
        print(f"[checkpoint] WARNING: {primary_err}; resumed from "
              f"last-good {prev}", file=sys.stderr)
        state["_recovered_from_prev"] = True
        return state
